"""The recurrent Q net in PyTorch: the net of the fused DRQN trainer and of
the per-agent model (port of the flax ``DRQNTrunk``, ``DRQNNet`` and
``split_unroll`` and of ``DeepRecurrentQNetwork``,
``magent_tpu/builtin/jax_model/drqn.py:28-148`` and ``:149-402``).

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

import copy
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...parallel.optim import ClipAdam
from ...parallel.sharding import linear, matmul, split_of
from .base import (CheckpointModel, compute_dtype, deterministic_convolutions,
                   round_up_pow2)
from .dqn import DTYPES
from .flax_params import init_dense_

REMAT = (False, True, "dots", "all")


def _cols(layer, dt):
    """(``layer.weight.T`` in ``dt``, its ``tp`` sharding or None): the
    arguments of :func:`~...parallel.sharding.matmul`."""
    return layer.weight.to(dt).t(), split_of(layer, "weight")


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
        h_view = F.relu(linear(self.dense_view, flat, dt))
        h_emb = F.relu(linear(self.dense_emb, feature.to(dt), dt))
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
        lin = lambda k, v: linear(self.get_submodule(k), v, dt)  # noqa: E731
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
    xr, xz, xn = ((matmul(x, *_cols(g.get_submodule(k), dt))
                   + g.get_submodule(k).bias.to(dt)).reshape(T, N, H)
                  for k in ("ir", "iz", "in"))
    khr, khz, khn = (_cols(g.get_submodule(k), dt)
                     for k in ("hr", "hz", "hn"))
    hn_bias = g.hn.bias
    # under no_grad nothing is stored: every form runs plain
    remat = torch.is_grad_enabled() and remat

    def step(h, t):
        k = None if keep is None else keep[t]
        if remat == "all":
            def whole(h, xr, xz, xn, k):
                hd = h.to(dt)
                return _carry_step(h, xr, xz, xn, matmul(hd, *khr),
                                   matmul(hd, *khz), matmul(hd, *khn),
                                   hn_bias, k)
            return checkpoint(whole, h, xr[t], xz[t], xn[t], k,
                              use_reentrant=False)
        hd = h.to(dt)
        args = (h, xr[t], xz[t], xn[t], matmul(hd, *khr), matmul(hd, *khz),
                matmul(hd, *khn), hn_bias, k)
        if remat:  # "dots" / True: the matmul outputs stay stored
            return checkpoint(_carry_step, *args, use_reentrant=False)
        return _carry_step(*args)

    h, outs = h0, []
    for t in range(T):
        h, out = step(h, t)
        outs.append(out)
    return net.heads(torch.stack(outs).reshape(T * N, H)).reshape(T, N, -1)


class DeepRecurrentQNetwork(CheckpointModel):
    """The per-agent deep recurrent Q network (JAX ``jax_model/drqn.py:
    149-402``; reference: python/magent/builtin/tf_model/drqn.py): the GRU's
    hidden state kept per agent id across ``infer_action`` calls on the
    host (``agent_states``), e-greedy drawn as the DQN's; an episode-list
    replay of at most ``memory_size`` steps, sampled in proportion to
    episode length, and truncated BPTT over ``unroll_step`` windows from a
    zero state (:func:`split_unroll`), double and dueling Q, the target net
    copied every ``target_update`` batches (and at each call's first),
    ``clip_by_global_norm(5)`` then Adam.

    Same arguments as the JAX class, plus ``device`` (``None``: the card).
    Fresh nets are flax's initializers drawn from a torch generator seeded
    ``seed``."""

    def __init__(self, env, handle, name,
                 batch_size=32, unroll_step=8, reward_decay=0.99,
                 learning_rate=1e-4, train_freq=1, memory_size=20000,
                 target_update=2000, eval_obs=None, use_dueling=True,
                 use_double=True, use_episode_train=False,
                 custom_view_space=None, custom_feature_space=None, seed=0,
                 dtype="f32", device=None, **kwargs):
        CheckpointModel.__init__(self, env, handle, name, "tfdrqn",
                                 device=device, seed=seed)

        self.view_space = custom_view_space or env.get_view_space(handle)
        self.feature_space = (custom_feature_space
                              or env.get_feature_space(handle))
        self.num_actions = env.get_action_space(handle)[0]
        self.batch_size = int(batch_size)
        self.unroll_step = int(unroll_step)
        self.gamma = reward_decay
        self.train_freq = train_freq
        self.memory_size = memory_size
        self.target_update = target_update
        self.eval_obs = eval_obs
        self.use_double = use_double
        self.train_ct = 0

        self.net = DRQNNet(self.view_space, self.feature_space[0],
                           self.num_actions, use_dueling,
                           dtype=compute_dtype(dtype),
                           generator=torch.Generator().manual_seed(seed)
                           ).to(self.device)
        self.state_size = self.net.state_size
        self.tx = ClipAdam(learning_rate, 5.0)
        self._restart_training()

        # per-agent persistent hidden state (drqn.py:188-203)
        self.agent_states = {}

        # episode-list replay buffer (drqn.py:280-299)
        self.replay_buffer = []
        self.replay_buffer_lens = []

    def _restart_training(self):
        self.target_net = copy.deepcopy(self.net).requires_grad_(False)
        self.opt_state = self.tx.init(self.net)

    # ----------------------------------------------------- hidden state mgmt
    def _get_agent_states(self, ids):
        default = np.zeros(self.state_size, np.float32)
        return np.stack([self.agent_states.get(i, default) for i in ids])

    def _set_agent_states(self, ids, states):
        if len(ids) <= len(self.agent_states) * 0.5:
            self.agent_states = {}
        for i, s in zip(ids, states):
            self.agent_states[i] = s

    # ------------------------------------------------------------ inference
    def _step(self, states, view, feature):
        """One GRU step of the online net on host arrays -> (new states
        ``[n, H]``, Q ``[n, n_act]``) on the device (no gradient)."""
        with torch.no_grad():
            return self.net(self._tensor(states), self._tensor(view),
                            self._tensor(feature))

    def infer_action(self, raw_obs, ids, policy="e_greedy", eps=0,
                     block=True):
        view, feature = raw_obs[0], raw_obs[1]
        n = len(ids)
        if n == 0:
            return np.empty(0, np.int32)
        if policy == "greedy":
            eps = 0.0
        new_state, q = self._step(self._get_agent_states(ids), view, feature)
        acts = self._egreedy(q, round_up_pow2(n), eps)
        self._set_agent_states(ids, new_state.cpu().numpy())
        return acts.cpu().numpy()

    # ------------------------------------------------------------- training
    def _add_to_replay_buffer(self, sample_buffer):
        n = 0
        for episode in sample_buffer.episodes():
            v, f = np.asarray(episode.views), np.asarray(episode.features)
            a = np.asarray(episode.actions, np.int32)
            r = np.asarray(episode.rewards, np.float32)
            m = len(r)
            mask = np.ones(m, np.float32)
            terminal = np.zeros(m, bool)
            if episode.terminal:
                terminal[-1] = True
            else:
                mask[-1] = 0
            self.replay_buffer.append((v, f, a, r, terminal, mask))
            self.replay_buffer_lens.append(m)
            n += m
        # evict oldest episodes beyond memory_size total steps
        while sum(self.replay_buffer_lens) > self.memory_size and len(
            self.replay_buffer
        ) > 1:
            self.replay_buffer.pop(0)
            self.replay_buffer_lens.pop(0)
        return n

    def _train_step(self, vs, fs, as_, rs, ts, ms):
        """One gradient step on a window batch (views and features ``[U + 1,
        B, ...]``, the rest ``[U, B]``) -> (loss, mean target), 0-d tensors
        left on the device (JAX ``train_step``)."""
        vs, fs = self._tensor(vs), self._tensor(fs)
        actions = self._tensor(as_, np.int64)
        rewards, mask = self._tensor(rs), self._tensor(ms)
        terminal = self._tensor(ts, bool)
        h0 = torch.zeros((vs.shape[1], self.state_size), device=self.device)
        with torch.no_grad():
            t_q = split_unroll(self.target_net, vs[1:], fs[1:], h0)
            if self.use_double:
                sel = split_unroll(self.net, vs[1:], fs[1:], h0).argmax(
                    -1, keepdim=True)
                next_v = t_q.gather(-1, sel)[..., 0]
            else:
                next_v = t_q.max(-1).values
            target = torch.where(terminal, rewards,
                                 rewards + self.gamma * next_v)
        q = split_unroll(self.net, vs[:-1], fs[:-1], h0)
        q_a = q.gather(-1, actions[..., None])[..., 0]
        loss = ((target - q_a).square() * mask).sum() / \
            mask.sum().clamp_min(1.0)
        self.net.zero_grad(set_to_none=True)
        loss.backward()
        self.opt_state = self.tx.update(self.net, self.opt_state)
        return loss.detach(), target.mean()

    @deterministic_convolutions()
    def train(self, sample_buffer, print_every=500, **kwargs):
        add_num = self._add_to_replay_buffer(sample_buffer)
        B, U = self.batch_size, self.unroll_step
        lens = np.asarray(self.replay_buffer_lens, np.float64)
        weight = lens / lens.sum()

        n_batches = int(self.train_freq * add_num / (B * U))
        if n_batches == 0:
            return 0, 0
        print("batches: %d  add: %d  replay_len: %d/%d" %
              (n_batches, add_num, int(lens.sum()), self.memory_size))

        vs = np.zeros((U + 1, B) + tuple(self.view_space), np.float32)
        fs = np.zeros((U + 1, B) + tuple(self.feature_space), np.float32)
        as_ = np.zeros((U, B), np.int32)
        rs = np.zeros((U, B), np.float32)
        ts = np.zeros((U, B), bool)
        ms = np.zeros((U, B), np.float32)

        ct = 0
        losses, last_tgt = [], 0.0
        start_time = time.time()
        for _ in range(n_batches):
            idx = np.random.choice(len(self.replay_buffer), B, p=weight)
            # reset every window buffer: rows past a short window's `real`
            # are loss-masked but still enter the mean target
            vs[:] = 0; fs[:] = 0; as_[:] = 0; rs[:] = 0; ms[:] = 0  # noqa: E702
            ts[:] = False
            for j, e_i in enumerate(idx):
                v, f, a, r, t, m = self.replay_buffer[e_i]
                length = len(a)
                start = np.random.randint(length)
                real = min(length - start, U)
                # obs window covers [start, start+real]; when the episode
                # ends inside the window the final next-obs is a duplicate
                # of the last obs (its transition is masked below)
                end = min(start + real + 1, length)
                vs[: end - start, j] = v[start:end]
                fs[: end - start, j] = f[start:end]
                if end - start == real:
                    vs[real, j] = v[end - 1]
                    fs[real, j] = f[end - 1]
                as_[:real, j] = a[start : start + real]
                rs[:real, j] = r[start : start + real]
                ts[:real, j] = t[start : start + real]
                ms[:real, j] = m[start : start + real]
                if start + real == length and not t[length - 1]:
                    # truncated episode tail: no valid next obs (drqn.py:362)
                    ms[real - 1, j] = 0.0
            loss, last_tgt = self._train_step(vs, fs, as_, rs, ts, ms)
            losses.append(loss)  # read once, after the loop
            if ct % self.target_update == 0:
                self.target_net.load_state_dict(self.net.state_dict())
            if ct % print_every == 0:
                print("batch %5d, loss %.6f, qvalue %.6f" %
                      (ct, float(loss), float(last_tgt)))
            ct += 1
            self.train_ct += 1

        total_loss = float(torch.stack(losses).sum())
        total_time = time.time() - start_time
        print("batches: %d,  total time: %.2f,  1k average: %.2f" %
              (ct, total_time, total_time / max(1.0, ct / 1000.0)))
        return total_loss / ct, self._eval(last_tgt)

    def _eval(self, fallback):
        """Estimated q on the held-out eval set: the target net's Q values
        from a zero state (one step), plain mean over actions, as the
        reference's eval feed (drqn.py:567-575); the mean training target
        without an eval set."""
        if self.eval_obs is None:
            return float(fallback)
        ev, ef = self.eval_obs
        with torch.no_grad():
            _, q = self.target_net(
                torch.zeros((len(ev), self.state_size), device=self.device),
                self._tensor(ev), self._tensor(ef))
        return float(q.mean())

    def get_info(self):
        return "drqn train_time: %d" % self.train_ct
