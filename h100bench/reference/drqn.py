"""MAgent's deep recurrent Q network (python/magent/builtin/tf_model/drqn.py)
in plain float32 PyTorch operations, on parameter tensors held in a dict,
and its fused training step: the window's unroll, the double-DQN TD loss
back-propagated through time, clip and Adam.

One agent step: dense(256) over the flattened view and dense(256) over the
features, concatenated to 512, into a GRU cell of ``state_size``, then the
dueling heads ``value + advantage - mean(advantage)`` (or one dense layer
without dueling).  Views come channel-last ``[N, vh, vw, C]`` and are
flattened in (y, x, c) order.  Parameter names and layouts are PyTorch's
(``nn.Linear`` ``[out, in]``) under the program's module paths.

Where this departs from MAgent's TF net, as the program does:

- the cell is flax's ``GRUCell``, not ``tf.nn.rnn_cell.GRUCell``: ``r =
  sigmoid(ir(x) + hr(h))``, ``z = sigmoid(iz(x) + hz(h))``, ``n =
  tanh(in(x) + r * hn(h))``, ``h' = (1 - z) * n + z * h``; ``ir``, ``iz``,
  ``in`` and ``hn`` carry a bias, ``hr`` and ``hz`` none (TF gates the
  state before its projection and computes ``z`` as the keep gate's
  complement);
- the TD loss is over the fused trainer's window of every agent, from the
  state the window started in, not over windows sampled from an episode
  replay and unrolled from zero.

``quant`` rounds each layer's input and weights before the layer (the
lower-precision control); ``None`` computes in float32.  The caller turns
TF32 off (:func:`exact_float32`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dqn import Adam, bf16, exact_float32, fp8, init_params  # noqa: F401

GATES_IN = ("ir", "iz", "in")
GATES_STATE = ("hr", "hz", "hn")


def param_shapes(view_space, feature_size, n_action, net):
    vh, vw, C = view_space
    d, H = net["dense"], net["state_size"]
    shapes = {
        "trunk.dense_view.weight": (d, vh * vw * C), "trunk.dense_view.bias": (d,),
        "trunk.dense_emb.weight": (d, feature_size), "trunk.dense_emb.bias": (d,),
    }
    for k in GATES_IN:
        shapes["gru.%s.weight" % k] = (H, 2 * d)
        shapes["gru.%s.bias" % k] = (H,)
    for k in GATES_STATE:
        shapes["gru.%s.weight" % k] = (H, H)
    shapes["gru.hn.bias"] = (H,)
    if net["dueling"]:
        shapes.update({"value.weight": (1, H), "value.bias": (1,),
                       "advantage.weight": (n_action, H)})
    else:
        shapes.update({"value.weight": (n_action, H), "value.bias": (n_action,)})
    return shapes


def _q(x, quant):
    return x if quant is None else quant(x)


def _dense(p, name, x, quant):
    b = p.get(name + ".bias")
    return F.linear(_q(x, quant), _q(p[name + ".weight"], quant),
                    None if b is None else _q(b, quant))


def step(p, h, view, feat, quant=None):
    """One agent step from the state ``h`` ``[N, H]`` -> (new state ``[N,
    H]``, Q values ``[N, n_action]``), f32."""
    n = view.shape[0]
    hv = F.relu(_dense(p, "trunk.dense_view", view.float().reshape(n, -1), quant))
    he = F.relu(_dense(p, "trunk.dense_emb", feat.float(), quant))
    x = torch.cat([hv, he], 1)
    r = torch.sigmoid(_dense(p, "gru.ir", x, quant) + _dense(p, "gru.hr", h, quant))
    z = torch.sigmoid(_dense(p, "gru.iz", x, quant) + _dense(p, "gru.hz", h, quant))
    c = torch.tanh(_dense(p, "gru.in", x, quant) + r * _dense(p, "gru.hn", h, quant))
    h2 = (1.0 - z) * c + z * h
    if "advantage.weight" not in p:
        return h2, F.linear(h2, p["value.weight"], p["value.bias"])
    value = F.linear(h2, p["value.weight"], p["value.bias"])
    adv = F.linear(h2, p["advantage.weight"])
    return h2, value + adv - adv.mean(1, keepdim=True)


def unroll(p, h0, views, feats, keep, quant=None, cut=False):
    """Q values ``[T, N, n_action]`` over a window (views ``[T, N, vh, vw,
    C]``, features ``[T, N, F]``) from the state ``h0`` ``[N, H]``, and
    the state after it.  ``keep`` ``[T, N]`` bool zeroes the state after a
    frame (an agent that died, an episode that ended); the frame's Q
    values come from the state before.  ``cut`` detaches the state at each
    frame (back-propagation through one frame only: a planted fault)."""
    h, qs = h0, []
    for t in range(views.shape[0]):
        h2, q = step(p, h, views[t], feats[t], quant)
        qs.append(q)
        h = torch.where(keep[t][:, None], h2, 0.0)
        if cut:
            h = h.detach()
    return torch.stack(qs), h


def td_sum(qs, tqs, act, rew, terminal, mask, gamma):
    """The double-DQN TD(0) loss of a window, as (sum over the frames but
    the last of ``mask * (target - Q(s, a))^2``, sum of ``mask``): ``target
    = rew`` if terminal else ``rew + gamma * Qt(s', argmax_a Q(s', a))``,
    with Q the online unroll ``qs`` and Qt the target unroll ``tqs``, both
    ``[T, N, n_action]``; the rest ``[T, N]``.  Sums over agents add up, so
    the loss of a batch is the sum of its blocks' over the batch's
    ``mask`` sum."""
    q_t = qs[:-1].gather(-1, act[:-1].long()[..., None])[..., 0]
    with torch.no_grad():
        sel = qs[1:].argmax(-1, keepdim=True)
        nv = tqs[1:].gather(-1, sel)[..., 0]
    target = torch.where(terminal[:-1], rew[:-1], rew[:-1] + gamma * nv)
    m = mask[:-1].float()
    return ((target - q_t).square() * m).sum(), m.sum()
