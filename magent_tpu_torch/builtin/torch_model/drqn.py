"""The fused DRQN trainer's recurrent Q net in PyTorch (port of the flax
``DRQNTrunk``, ``DRQNNet`` and ``split_unroll`` of
``magent_tpu/builtin/jax_model/drqn.py:28-148``).

One step: the dense trunk (``dense_view``, ``dense_emb``, 256 each, in
the compute ``dtype``) into a GRU cell of ``state_size`` (512) and the
dueling (or plain) Q heads in f32.  The cell is flax 0.12's ``GRUCell``:
``r = sigmoid(ir(x) + hr(h))``, ``z = sigmoid(iz(x) + hz(h))``, ``n =
tanh(in(x) + r * hn(h))``, ``h' = (1 - z) * n + z * h``; ``ir``, ``iz``,
``in`` and ``hn`` carry a bias, ``hr`` and ``hz`` none.  The whole cell
runs in ``dtype``, as flax's does (its gates in bf16 for a bf16 net); the
carried state and the heads stay f32.

:func:`split_unroll` evaluates a stored window: the trunk, the input
projections and the heads batched over ``[T, N]``, only the carry half of
the cell stepped over T, its pre-activations in f32 (JAX ``drqn.py:
125-131``).  Parameter names are the flax paths (:mod:`.flax_params`);
``in`` is a keyword, so that module is reached as ``gru.get_submodule
("in")``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .dqn import DTYPES
from .flax_params import init_dense_

REMAT = (False, True, "dots", "all")


def _linear(layer, x, dt):
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x, layer.weight.to(dt), bias)


class DRQNTrunk(nn.Module):
    def __init__(self, view_size: int, feature_size: int,
                 dtype=torch.float32):
        super().__init__()
        self.view_size = view_size
        self.dtype = dtype
        self.dense_view = nn.Linear(view_size, 256)
        self.dense_emb = nn.Linear(feature_size, 256)

    def forward(self, view, feature):
        """[N, vh, vw, C], [N, F] -> [N, 512] f32."""
        dt = self.dtype
        flat = view.reshape(view.shape[0], self.view_size).to(dt)
        h_view = F.relu(_linear(self.dense_view, flat, dt))
        h_emb = F.relu(_linear(self.dense_emb, feature.to(dt), dt))
        return torch.cat([h_view, h_emb], 1).float()


class GRUCell(nn.Module):
    """flax ``GRUCell``'s parameters (``ir``, ``iz``, ``in``, ``hr``,
    ``hz``, ``hn``) and its step in ``dtype``."""

    def __init__(self, in_size: int, state_size: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_size, state_size))
        for name in ("hr", "hz"):
            self.add_module(name, nn.Linear(state_size, state_size,
                                            bias=False))
        self.hn = nn.Linear(state_size, state_size)

    def forward(self, h, x):
        """-> the new state in ``dtype``."""
        dt = self.dtype
        h, x = h.to(dt), x.to(dt)
        lin = lambda k, v: _linear(self.get_submodule(k), v, dt)  # noqa: E731
        r = torch.sigmoid(lin("ir", x) + lin("hr", h))
        z = torch.sigmoid(lin("iz", x) + lin("hz", h))
        n = torch.tanh(lin("in", x) + r * lin("hn", h))
        return (1.0 - z) * n + z * h


class DRQNNet(nn.Module):
    """``DRQNNet(view_space, feature_size, num_actions)``: one GRU step
    ``(state [N, H], view [N, vh, vw, C], feature [N, F]) -> (new state
    [N, H] f32, q [N, num_actions] f32)``.  Fresh parameters follow flax's
    initializers (``lecun_normal`` dense kernels, ``orthogonal`` recurrent
    kernels, zero biases), drawn from ``generator`` (a new one seeded 0 if
    None)."""

    def __init__(self, view_space, feature_size: int, num_actions: int,
                 use_dueling: bool = True, state_size: int = 512,
                 dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError("DRQNNet: dtype must be torch.float32 or "
                             "torch.bfloat16, got %s" % dtype)
        vh, vw, C = view_space
        self.num_actions = num_actions
        self.use_dueling = use_dueling
        self.state_size = state_size
        self.dtype = dtype
        self.trunk = DRQNTrunk(vh * vw * C, feature_size, dtype)
        self.gru = GRUCell(512, state_size, dtype)
        if use_dueling:
            self.value = nn.Linear(state_size, 1)
            self.advantage = nn.Linear(state_size, num_actions, bias=False)
        else:
            self.value = nn.Linear(state_size, num_actions)
        gen = generator or torch.Generator().manual_seed(0)
        init_dense_(self, gen)
        with torch.no_grad():
            for name in ("hr", "hz", "hn"):
                nn.init.orthogonal_(self.gru.get_submodule(name).weight,
                                    generator=gen)

    def heads(self, out):
        """Q ``[N, num_actions]`` of GRU outputs ``[N, H]``, f32."""
        if not self.use_dueling:
            return self.value(out)
        adv = self.advantage(out)
        return self.value(out) + adv - adv.mean(1, keepdim=True)

    def forward(self, state, view, feature):
        new_state = self.gru(state, self.trunk(view, feature)).float()
        return new_state, self.heads(new_state)


def _carry_step(h, xr, xz, xn, ar, az, an, hn_bias, keep):
    """The carry half of the cell from the projections ``x*`` of the input
    and ``a*`` of the state, in f32 -> (carry, output)."""
    f32 = torch.float32
    r = torch.sigmoid(xr.to(f32) + ar.to(f32))
    z = torch.sigmoid(xz.to(f32) + az.to(f32))
    n = torch.tanh(xn.to(f32) + r * (an.to(f32) + hn_bias))
    h2 = (1.0 - z) * n + z * h
    return (h2 if keep is None else torch.where(keep, h2, 0.0)), h2


def split_unroll(net: DRQNNet, views, features, h0, keep=None, remat=False):
    """q ``[T, N, num_actions]`` of ``net`` over a stored window (views
    ``[T, N, vh, vw, C]``, features ``[T, N, F]``) from the state ``h0``
    ``[N, H]`` f32: what stepping ``net`` frame by frame gives, up to the
    cell's rounding (its gates here add in f32).

    ``keep`` ``[T, N, 1]`` bool zeroes the carry after a frame (the frame's
    q still comes from the state before the reset).  ``remat`` (JAX's
    values; it changes what the backward stores, never the values):
    ``"all"`` recomputes each step from the carried state
    (``torch.utils.checkpoint``); ``"dots"`` or True keeps the three state
    matmuls and recomputes the elementwise gates; False stores all."""
    if remat not in REMAT:
        raise ValueError("remat must be one of %s, got %r" % (REMAT, remat))
    T, N = views.shape[:2]
    H, dt = net.state_size, net.dtype
    x = net.trunk(views.reshape((T * N,) + tuple(views.shape[2:])),
                  features.reshape(T * N, -1)).to(dt)
    g = net.gru
    # each projection rounds to dt before its bias add, as JAX's does
    xr, xz, xn = ((x @ g.get_submodule(k).weight.to(dt).t()
                   + g.get_submodule(k).bias.to(dt)).reshape(T, N, H)
                  for k in ("ir", "iz", "in"))
    khr, khz, khn = (g.get_submodule(k).weight.to(dt).t()
                     for k in ("hr", "hz", "hn"))
    hn_bias = g.hn.bias
    # under no_grad nothing is stored: every form runs plain
    remat = torch.is_grad_enabled() and remat

    def step(h, t):
        k = None if keep is None else keep[t]
        if remat == "all":
            def whole(h, xr, xz, xn, k):
                hd = h.to(dt)
                return _carry_step(h, xr, xz, xn, hd @ khr, hd @ khz,
                                   hd @ khn, hn_bias, k)
            return checkpoint(whole, h, xr[t], xz[t], xn[t], k,
                              use_reentrant=False)
        hd = h.to(dt)
        args = (h, xr[t], xz[t], xn[t], hd @ khr, hd @ khz, hd @ khn,
                hn_bias, k)
        if remat:  # "dots" / True: the matmul outputs stay stored
            return checkpoint(_carry_step, *args, use_reentrant=False)
        return _carry_step(*args)

    h, outs = h0, []
    for t in range(T):
        h, out = step(h, t)
        outs.append(out)
    return net.heads(torch.stack(outs).reshape(T * N, H)).reshape(T, N, -1)
