"""Flax parameter names and layouts <-> the port's nets.

A flax checkpoint is flat, as ``jax_model/base.py``'s ``_flatten_pytree``
writes it: ``{"trunk/dense_view/kernel": ndarray, ...}``.  The port's nets
name their modules after the flax modules, so a flax path ``a/b/kernel``
is the parameter ``a.b.weight``: a dense kernel ``[in, out]`` there is
``[out, in]`` here, a conv kernel HWIO there is OIHW here.  ``a/b/bias``
is ``a.b.bias``; any other leaf (CommNet's ``step_0_C``) keeps its name
and layout."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _to_torch_layout(kernel: np.ndarray) -> np.ndarray:
    return kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T


def _to_flax_layout(weight: np.ndarray) -> np.ndarray:
    return weight.transpose(2, 3, 1, 0) if weight.ndim == 4 else weight.T


def params_from_flax(flat: dict) -> dict:
    """A flat flax checkpoint (as ``np.load`` of a ``tf*_<n>.npz`` gives
    it) -> a ``state_dict`` of f32 CPU tensors for ``load_state_dict``."""
    out = {}
    for path, value in flat.items():
        *mods, leaf = path.split("/")
        a = np.asarray(value, np.float32)
        if leaf == "kernel":
            leaf, a = "weight", _to_torch_layout(a)
        out[".".join(mods + [leaf])] = torch.tensor(np.ascontiguousarray(a))
    return out


def tensors_to_flax(named: dict) -> dict:
    """``{"a.b.weight": tensor, ...}`` in a port net's layout (its
    parameters, or anything shaped like them, such as Adam moments) ->
    flax names and layouts, float32 numpy."""
    out = {}
    for name, p in named.items():
        *mods, leaf = name.split(".")
        a = p.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            leaf, a = "kernel", _to_flax_layout(a)
        out["/".join(mods + [leaf])] = np.array(a, order="C")  # a copy
    return out


def params_to_flax(net: nn.Module) -> dict:
    """A port net -> its flat flax checkpoint of float32 numpy arrays (the
    inverse of :func:`params_from_flax`; ``np.savez(path,
    **params_to_flax(net))`` writes one)."""
    return tensors_to_flax(net.state_dict())


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def init_dense_(module: nn.Module, generator: torch.Generator) -> None:
    """Every ``nn.Linear`` and ``nn.Conv2d`` in ``module``: flax
    ``nn.Dense``'s and ``nn.Conv``'s defaults (``lecun_normal`` kernel over
    the fan-in, a conv's window times its input channels; zero bias)."""
    for layer in module.modules():
        if isinstance(layer, (nn.Linear, nn.Conv2d)):
            fan_in = layer.weight[0].numel()
            lecun_normal_(layer.weight, fan_in, generator)
            if layer.bias is not None:
                nn.init.zeros_(layer.bias)
