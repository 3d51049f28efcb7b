"""Checkpointing base of the second backend (port of
``magent_tpu/builtin/torch_model/base.py``).

The JAX package ships an independent second NN backend beside its JAX
models, as the reference shipped MXNet beside TensorFlow
(python/magent/builtin/{tf,mx}_model): PyTorch models with a parameter
layout and checkpoints of their own.  This is that backend, on
``device`` (``None``: the card) instead of the CPU alone.

Checkpoints use the per-model directory scheme
(``save_model/<name>/<subclass>_<epoch>.npz``, flat NumPy archives of the
``state_dict``) with the subclass prefixes ``thdqn``/``tha2c``: the JAX
package's files, loadable by either package.

Fresh nets are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
in PyTorch's default initializers' order (:func:`init_default_`), which
gives the tensors of ``torch.manual_seed(seed)`` and a plain construction,
the JAX package's, without touching the global generator; then they move
to the device.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from ...model import BaseModel
from ...parallel.vec_env import resolve_device
from ..torch_model.base import latest_epoch, round_up_pow2

__all__ = ["TorchBaseModel", "build_net", "init_default_", "latest_epoch",
           "round_up_pow2"]


def init_default_(net: nn.Module, generator: torch.Generator) -> None:
    """Every ``nn.Linear`` and ``nn.Conv2d`` of ``net``, in registration
    order: its ``reset_parameters`` drawn from ``generator``
    (``kaiming_uniform_(a=sqrt(5))`` for the weight, then
    ``uniform_(+-1/sqrt(fan_in))`` for the bias)."""
    with torch.no_grad():
        for layer in net.modules():
            if not isinstance(layer, (nn.Linear, nn.Conv2d)):
                continue
            nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5),
                                     generator=generator)
            if layer.bias is not None:
                fan_in = layer.weight[0].numel()
                bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
                nn.init.uniform_(layer.bias, -bound, bound,
                                 generator=generator)


def build_net(cls, *args, seed=0, device="cpu"):
    """``cls(*args)`` with fresh parameters drawn from a CPU generator
    seeded ``seed`` (:func:`init_default_`; built on the meta device first,
    so that construction draws nothing), moved to ``device``."""
    with torch.device("meta"):
        net = cls(*args)
    net = net.to_empty(device="cpu")
    init_default_(net, torch.Generator().manual_seed(seed))
    return net.to(device)


class TorchBaseModel(BaseModel):
    """A model over one net ``self.net`` (set by the subclass) on
    ``self.device`` (``None``: the card, raising without one)."""

    def __init__(self, env, handle, name, subclass_name, device=None):
        super().__init__(env, handle)
        self.name = name
        self.subclass_name = subclass_name
        self.device = resolve_device(device)

    def _tensor(self, a, dtype=np.float32):
        """A host array as a tensor on the model's device."""
        return torch.from_numpy(np.array(a, dtype)).to(self.device)

    # subclasses expose .net (nn.Module); override these for extra state
    def state_arrays(self):
        return {k: v.detach().cpu().numpy()
                for k, v in self.net.state_dict().items()}

    def load_state_arrays(self, flat):
        """Load a flat ``state_dict`` of NumPy arrays (the JAX model's
        ``state_arrays()``, a checkpoint) onto the model's device."""
        self.net.load_state_dict(
            {k: torch.from_numpy(np.asarray(v)).to(self.device)
             for k, v in flat.items()})

    def save(self, dir_name, epoch):
        dir_name = os.path.join(dir_name, self.name)
        os.makedirs(dir_name, exist_ok=True)
        path = os.path.join(dir_name, self.subclass_name + "_%d.npz" % epoch)
        np.savez(path, **self.state_arrays())

    def load(self, dir_name, epoch=0, name=None):
        name = name or self.name
        path = os.path.join(dir_name, name,
                            self.subclass_name + "_%d.npz" % epoch)
        with np.load(path) as flat:
            self.load_state_arrays(dict(flat))
