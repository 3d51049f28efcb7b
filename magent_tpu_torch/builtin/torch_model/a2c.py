"""The fused A2C trainer's actor-critic net in PyTorch (port of the flax
``CommNet`` and ``A2CNet`` of ``magent_tpu/builtin/jax_model/a2c.py:27-83``).

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

import torch
import torch.nn.functional as F
from torch import nn

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
            h = torch.tanh(message @ getattr(self, "step_%d_C" % i)
                           + h @ getattr(self, "step_%d_H" % i) + skip)
        return h


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
        dt = self.dtype
        return F.relu(F.linear(x, layer.weight.to(dt), layer.bias.to(dt)))

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
