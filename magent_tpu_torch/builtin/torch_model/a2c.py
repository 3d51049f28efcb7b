"""The actor-critic net in PyTorch: the net of the fused A2C trainer and of
the per-agent model (port of the flax ``CommNet`` and ``A2CNet`` and of
``AdvantageActorCritic``, ``magent_tpu/builtin/jax_model/a2c.py:27-83`` and
``:86-233``).

Dense trunk: the flattened view (in (y, x, c) order, as flax flattens) and
the features through ``dense_view`` and ``dense_emb`` (256 each), their
concatenation through ``dense_joint`` (512), all in the trunk's compute
``dtype``; then, with ``use_comm``, two CommNet steps; then a softmax
``policy`` clipped to [1e-10, 1 - 1e-10] and a ``value`` head, in f32.

CommNet pools over the agents of one env's group.  Where the JAX trainer
vmaps the flax module per env, :class:`A2CNet` takes any leading shape
``[..., cap]`` and pools over the ``cap`` axis of every leading index at
once.  Parameter names are the flax paths (:mod:`.flax_params`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import random as rnd
from ...parallel.optim import ClipAdam
from ...parallel.sharding import linear, matmul, split_of
from .base import CheckpointModel, compute_dtype, round_up_pow2
from .dqn import DTYPES
from .flax_params import init_dense_, lecun_normal_

HIDDEN = 512


class CommNet(nn.Module):
    """Mean-message communication (S. Sukhbaatar et al., NIPS 2016):
    ``n_step`` steps of ``h = tanh(message @ C + h @ H + skip)``, the
    message the mean of the *other* live agents' ``h`` (0 where at most one
    agent lives)."""

    def __init__(self, hidden_size: int, n_step: int = 2):
        super().__init__()
        self.n_step = n_step
        for i in range(n_step):
            for name in ("C", "H"):
                self.register_parameter(
                    "step_%d_%s" % (i, name),
                    nn.Parameter(torch.empty(hidden_size, hidden_size)))

    def forward(self, h, mask):
        """``h`` [..., cap, hidden] f32, ``mask`` [..., cap] f32 (1 live)."""
        skip = h
        m = mask[..., None]
        count = mask.sum(-1)[..., None, None]
        denom = torch.where(count > 1.0, count - 1.0, torch.inf)
        for i in range(self.n_step):
            total = (h * m).sum(-2, keepdim=True)
            message = (total - h * m) / denom
            h = torch.tanh(self._mm(message, "step_%d_C" % i)
                           + self._mm(h, "step_%d_H" % i) + skip)
        return h

    def _mm(self, x, name):
        """``x @ <name>``, column-parallel where ``tp`` splits it."""
        return matmul(x, getattr(self, name), split_of(self, name))


class A2CNet(nn.Module):
    """``A2CNet(view_space, feature_size, num_actions)``: (policy
    ``[..., num_actions]``, value ``[...]``), both f32, of views ``[...,
    vh, vw, C]``, features ``[..., F]`` and, with ``use_comm``, the live
    mask ``[...]`` (all live when None).  ``dtype`` is the trunk's compute
    dtype (the parameters stay f32).  Fresh parameters follow flax's
    initializers, drawn from ``generator`` (a new one seeded 0 if None)."""

    def __init__(self, view_space, feature_size: int, num_actions: int,
                 use_comm: bool = False, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError("A2CNet: dtype must be torch.float32 or "
                             "torch.bfloat16, got %s" % dtype)
        vh, vw, C = view_space
        self.view_size = vh * vw * C
        self.num_actions = num_actions
        self.use_comm = use_comm
        self.dtype = dtype
        self.dense_view = nn.Linear(self.view_size, 256)
        self.dense_emb = nn.Linear(feature_size, 256)
        self.dense_joint = nn.Linear(512, HIDDEN)
        if use_comm:
            self.comm = CommNet(HIDDEN)
        self.policy = nn.Linear(HIDDEN, num_actions)
        self.value = nn.Linear(HIDDEN, 1)
        gen = generator or torch.Generator().manual_seed(0)
        init_dense_(self, gen)
        if use_comm:
            for p in self.comm.parameters():
                lecun_normal_(p, HIDDEN, gen)

    def _dense(self, layer, x):
        return F.relu(linear(layer, x, self.dtype))

    def forward(self, view, feature, mask=None):
        dt = self.dtype
        lead = view.shape[:-3]
        h_view = self._dense(self.dense_view,
                             view.reshape(lead + (self.view_size,)).to(dt))
        h_emb = self._dense(self.dense_emb, feature.to(dt))
        dense = self._dense(self.dense_joint, torch.cat([h_view, h_emb], -1))
        dense = dense.float()
        if self.use_comm:
            if mask is None:
                mask = dense.new_ones(lead)
            dense = self.comm(dense, mask)
        policy = torch.softmax(self.policy(dense), -1).clamp(
            1e-10, 1.0 - 1e-10)
        return policy, self.value(dense)[..., 0]


class AdvantageActorCritic(CheckpointModel):
    """The per-agent advantage actor-critic, with CommNet on ``use_comm``
    (JAX ``jax_model/a2c.py:86-233``; reference:
    python/magent/builtin/tf_model/a2c.py): actions drawn by
    ``random.categorical`` on the policy's log, JAX's Gumbel-max draw at
    its padded shape (:meth:`_scores`); ``train`` takes one step on every
    recorded transition, the n-step returns bootstrapped from V of each
    episode's last observation evaluated alone (an all-zero CommNet mask,
    ``a2c.py:186-194``); loss = policy gradient + ``value_coef`` x value MSE
    + ``ent_coef`` x negative entropy; ``clip_by_global_norm(5)`` then Adam.

    Same arguments as the JAX class, plus ``device`` (``None``: the card);
    ``batch_size`` and ``train_freq`` are accepted and unused, as there.
    Fresh nets are flax's initializers drawn from a torch generator seeded
    ``seed``."""

    def __init__(self, env, handle, name, learning_rate=1e-3,
                 batch_size=64, reward_decay=0.99, eval_obs=None,
                 train_freq=1, value_coef=0.1, ent_coef=0.08, use_comm=False,
                 custom_view_space=None, custom_feature_space=None, seed=0,
                 dtype="f32", device=None, **kwargs):
        CheckpointModel.__init__(self, env, handle, name, "tfa2c",
                                 device=device, seed=seed)

        self.view_space = custom_view_space or env.get_view_space(handle)
        self.feature_space = (custom_feature_space
                              or env.get_feature_space(handle))
        self.num_actions = env.get_action_space(handle)[0]
        self.gamma = reward_decay
        self.value_coef = value_coef
        self.ent_coef = ent_coef
        self.train_ct = 0

        self.net = A2CNet(self.view_space, self.feature_space[0],
                          self.num_actions, use_comm,
                          dtype=compute_dtype(dtype),
                          generator=torch.Generator().manual_seed(seed)
                          ).to(self.device)
        self.tx = ClipAdam(learning_rate, 5.0)
        self._restart_training()

    def _restart_training(self):
        self.opt_state = self.tx.init(self.net)

    # ------------------------------------------------------------ inference
    def _scores(self, view, feature, key):
        """The categorical draw's scores ``[n, n_act]`` on the device:
        ``gumbel(key, [round_up_pow2(n), n_act])[:n] + log(policy)``, the
        policy of the n live rows (CommNet pooling over them); the action
        is their argmax."""
        n = len(view)
        with torch.no_grad():
            policy, _ = self.net(self._tensor(view), self._tensor(feature))
        noise = rnd.gumbel(key, (round_up_pow2(n), self.num_actions))[:n]
        return noise + torch.log(policy)

    def infer_action(self, raw_obs, ids, *args, **kwargs):
        view, feature = raw_obs[0], raw_obs[1]
        n = len(view)
        if n == 0:
            return np.empty(0, np.int32)
        scores = self._scores(view, feature, self._next_key())
        return scores.argmax(1).to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------- training
    def train(self, sample_buffer, print_every=1000, **kwargs):
        episodes = list(sample_buffer.episodes())
        n = sum(len(e.rewards) for e in episodes)
        if n == 0:
            return [0, 0, 0], 0

        view = np.empty((n,) + tuple(self.view_space), np.float32)
        feature = np.empty((n,) + tuple(self.feature_space), np.float32)
        action = np.empty(n, np.int32)
        ret = np.empty(n, np.float32)

        # bootstrap each episode's return from V(last obs) (a2c.py:253-265),
        # each row alone: the reference feeds num_agent=1, whose CommNet
        # message is 0; an all-zero mask gives that for every row at once
        last_v = np.stack([np.asarray(e.views[-1]) for e in episodes])
        last_f = np.stack([np.asarray(e.features[-1]) for e in episodes])
        with torch.no_grad():
            _, keeps = self.net(
                self._tensor(last_v), self._tensor(last_f),
                torch.zeros(len(episodes), device=self.device))
        keeps = keeps.cpu().numpy()

        ct = 0
        for e, keep in zip(episodes, keeps):
            m = len(e.rewards)
            r = np.asarray(e.rewards, np.float32).copy()
            acc = float(keep)
            for i in reversed(range(m)):
                acc = acc * self.gamma + r[i]
                r[i] = acc
            view[ct : ct + m] = e.views
            feature[ct : ct + m] = e.features
            action[ct : ct + m] = e.actions
            ret[ct : ct + m] = r
            ct += m

        ret_t = self._tensor(ret)
        policy, value = self.net(self._tensor(view), self._tensor(feature))
        advantage = (ret_t - value).detach()
        log_policy = torch.log(policy + 1e-6)
        log_prob = log_policy.gather(
            1, self._tensor(action, np.int64)[:, None])[:, 0]
        msum = float(max(n, 1))
        pg_loss = -(advantage * log_prob).sum() / msum
        vf_loss = self.value_coef * (ret_t - value).square().sum() / msum
        neg_entropy = self.ent_coef * (policy * log_policy).sum(1).sum() / msum
        self.net.zero_grad(set_to_none=True)
        (pg_loss + vf_loss + neg_entropy).backward()
        self.opt_state = self.tx.update(self.net, self.opt_state)
        pg, vf, ent, value = torch.stack(
            [pg_loss, vf_loss, neg_entropy, value.sum() / max(n, 1)]
        ).detach().tolist()
        self.train_ct += 1
        print("sample", n, pg, vf, ent)
        return [pg, vf, ent], value

    def get_info(self):
        return "a2c train_time: %d" % self.train_ct
