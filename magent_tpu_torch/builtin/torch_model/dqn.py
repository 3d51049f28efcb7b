"""The fused trainers' deep Q network in PyTorch (port of the flax
``DQNNet`` of ``magent_tpu/builtin/jax_model/dqn.py:28-60``).

conv(32, 3x3, valid) x2 + dense(256) view stream, dense(256) feature stream,
dueling value/advantage heads (reference: builtin/tf_model/dqn.py).  The
layer names are the flax module's, so that :func:`params_from_flax` and
:func:`params_to_flax` carry a checkpoint (``tfdqn_<n>.npz``, written by
``jax_model/base.py``'s ``_flatten_pytree``) across unchanged.

Layouts: the input view is channel-last ``[N, vh, vw, C]`` as the env
renders it; the convs run on its NCHW view (channels-last strides, no
copy), and the conv output is flattened in (y, x, c) order, as flax's NHWC
``reshape`` flattens it, so ``dense_view``'s weight is the flax kernel
transposed with no column permutation.  Conv kernels are HWIO in flax and
OIHW here; dense kernels ``[in, out]`` there, ``[out, in]`` here
(:mod:`.flax_params`).

The JAX package's CPU ``TorchDQNNet`` (``magent_tpu/builtin/torch_model``)
has a parameter layout of its own and is not this class.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .flax_params import params_from_flax, params_to_flax, tensors_to_flax

__all__ = ["DQNNet", "params_from_flax", "params_to_flax", "tensors_to_flax"]

DTYPES = (torch.float32, torch.bfloat16)


class DQNNet(nn.Module):
    """``DQNNet(view_space, feature_size, num_actions)``: Q values ``[N,
    num_actions]`` f32 of views ``[N, vh, vw, C]`` and features ``[N, F]``.

    ``dtype`` is the compute dtype of the convs and the two 256-wide dense
    layers (the flax module's ``dtype``): the parameters stay f32 and are
    cast inside the forward pass, so autograd carries the gradients back to
    the f32 parameters; the heads and the Q arithmetic run in f32.  Flax
    infers input widths at ``init``; here ``view_space`` ``(vh, vw, C)`` and
    ``feature_size`` give them."""

    def __init__(self, view_space, feature_size: int, num_actions: int,
                 use_dueling: bool = True, use_conv: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError("DQNNet: dtype must be torch.float32 or "
                             "torch.bfloat16, got %s" % dtype)
        vh, vw, C = view_space
        self.num_actions = num_actions
        self.use_dueling = use_dueling
        self.use_conv = use_conv
        self.dtype = dtype
        if use_conv:
            self.conv1 = nn.Conv2d(C, 32, 3)
            self.conv2 = nn.Conv2d(32, 32, 3)
            n_view = (vh - 4) * (vw - 4) * 32
        else:
            n_view = vh * vw * C
        self.dense_view = nn.Linear(n_view, 256)
        self.dense_emb = nn.Linear(feature_size, 256)
        if use_dueling:
            self.value = nn.Linear(512, 1)
            self.advantage = nn.Linear(512, num_actions, bias=False)
        else:
            self.value = nn.Linear(512, num_actions)

    def _trunk(self, layer, x, op):
        dt = self.dtype
        return F.relu(op(x, layer.weight.to(dt), layer.bias.to(dt)))

    def forward(self, view, feature):
        dt = self.dtype
        n = view.shape[0]
        h = view.to(dt)
        if self.use_conv:
            h = h.permute(0, 3, 1, 2)  # NCHW shape, channels-last strides
            h = self._trunk(self.conv1, h, F.conv2d)
            h = self._trunk(self.conv2, h, F.conv2d)
            h = h.permute(0, 2, 3, 1)  # (y, x, c) order, as flax flattens
        h_view = self._trunk(self.dense_view, h.reshape(n, -1), F.linear)
        h_emb = self._trunk(self.dense_emb, feature.to(dt), F.linear)
        dense = torch.cat([h_view, h_emb], 1).float()
        if not self.use_dueling:
            return self.value(dense)
        value = self.value(dense)
        advantage = self.advantage(dense)
        return value + advantage - advantage.mean(1, keepdim=True)
