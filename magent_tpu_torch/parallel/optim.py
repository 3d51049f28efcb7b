"""The fused trainers' optimizer: the counterpart of the optax chain
``clip_by_global_norm(max_norm)`` then ``adam(lr)`` (``scripts/bench_train.py:69``,
``examples/train_battle_fused.py:95``, ``jax_model/dqn.py:97-100``).

Like an optax ``GradientTransformation`` it keeps no state of its own:
:meth:`ClipAdam.init` gives one :class:`AdamState` per network (the JAX
trainers keep one per group), and :meth:`ClipAdam.update` takes the
gradients left in ``net``'s parameters by ``backward`` and updates the
parameters and the state in place, with optax's arithmetic:

- clip: ``g`` if ``norm < max_norm``, else ``g / norm * max_norm``, with
  ``norm`` the global L2 norm of all gradients (not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm);
- Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the
  bias corrections ``1 - b^count`` in f32, and the update ``-lr * mu_hat /
  (sqrt(nu_hat) + eps)``, eps outside the square root.

Everything stays on the parameters' device: the clip is a ``torch.where`` on
the device-side norm, and ``count`` is a host integer, so an update reads
nothing back from the card.

Under ``tp`` (a net placed by :func:`.sharding.device_put`, whose shards
carry their :class:`~.sharding.Sharding`): the global norm sums the
squares of the ``tp`` shards over ``tp`` and counts the replicated
parameters once; the moments are the shards' own.  The gradients come in
already summed over ``dp``: the trainer that owns the mesh reduces them
(``train._apply``), as it reduces its losses' counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and the first and second
    moments, one tensor per parameter in ``net.parameters()`` order."""

    count: int
    mu: list
    nu: list


# optax.adam's defaults, which every JAX trainer call keeps
B1, B2, EPS = 0.9, 0.999, 1e-8


class ClipAdam:
    """``clip_by_global_norm(max_norm)`` then ``adam(lr)``."""

    def __init__(self, lr: float = 1e-4, max_norm: float = 5.0):
        self.lr = lr
        self.max_norm = max_norm

    def init(self, net: nn.Module) -> AdamState:
        params = list(net.parameters())
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    def update(self, net: nn.Module, state: AdamState) -> AdamState:
        """One step on the gradients in ``net``'s ``.grad``s: the
        parameters, ``state.mu`` and ``state.nu`` change in place; returns
        ``state`` with its count advanced.  The gradients are cleared."""
        params = list(net.parameters())
        grads = [p.grad for p in params]
        norm = _global_norm(net, grads)
        keep = norm < self.max_norm
        grads = [torch.where(keep, g, g / norm * self.max_norm)
                 for g in grads]
        count = state.count + 1
        # 1 - b**count in f32 on the host, as optax's bias_correction
        # computes it (a Python float: no copy to the card)
        one = np.float32(1)
        bc1 = float(one - np.float32(B1) ** np.float32(count))
        bc2 = float(one - np.float32(B2) ** np.float32(count))
        with torch.no_grad():
            for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
                mu.copy_((1 - B1) * g + B1 * mu)
                nu.copy_((1 - B2) * g.square() + B2 * nu)
                p.add_(mu / bc1 / ((nu / bc2).sqrt() + EPS) * -self.lr)
                p.grad = None
        state.count = count
        return state


def _global_norm(net: nn.Module, grads) -> torch.Tensor:
    """The L2 norm of all of ``net``'s gradients: where ``tp`` splits some
    of its parameters, the squares of the shards summed over ``tp`` and
    those of the replicated ones counted once."""
    from .sharding import all_reduce, param_splits

    sq = [g.square().sum() for g in grads]
    splits = param_splits(net)
    shards = [s for s, split in zip(sq, splits) if split is not None]
    if not shards:
        return torch.stack(sq).sum().sqrt()
    rep = [s for s, split in zip(sq, splits) if split is None]
    mesh = next(split for split in splits if split is not None).mesh
    zero = torch.zeros((), device=grads[0].device)
    return (all_reduce(sum(shards, zero), mesh, "tp")
            + sum(rep, zero)).sqrt()
