"""Checkpointing base of the per-agent models (port of
``magent_tpu/builtin/jax_model/base.py``).

Per-model directories ``<dir>/<name>/<subclass>_<epoch>.npz``
(``tfdqn``, ``tfa2c``, ``tfdrqn``) with cross-name restore, as the
reference's (python/magent/builtin/tf_model/base.py:24-76).  A checkpoint
is the JAX package's: a flat archive of the flax parameter tree, written and
read through :func:`.flax_params.params_to_flax` and
:func:`.flax_params.params_from_flax`, so that either package loads what
the other saved, bit for bit.

The models keep the JAX models' random stream: ``key`` is a
:mod:`magent_tpu_torch.random` threefry key on the model's device, split
once per draw as ``jax.random.split`` is, and every draw is made at the
JAX model's padded shape (:func:`round_up_pow2`) and then sliced, since
threefry's bits depend on the whole shape drawn.  The nets themselves run
on the live rows only.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from ... import random as rnd
from ...model import BaseModel
from ...parallel.vec_env import resolve_device
from .flax_params import params_from_flax, params_to_flax


def latest_epoch(dir_name, name, subclass=None):
    """Highest saved epoch of ``dir_name/name`` or None when absent.
    With ``subclass=None`` any model family's checkpoints count
    (tfdqn/tfdrqn/tfa2c save under different prefixes)."""
    path = os.path.join(dir_name, name)
    if not os.path.isdir(path):
        return None
    pat = r"%s_(\d+)\.npz$" % (subclass if subclass else r"[a-z0-9]+")
    epochs = [int(m.group(1)) for f in os.listdir(path)
              for m in [re.match(pat, f)] if m]
    return max(epochs) if epochs else None


def round_up_pow2(n, lo=64):
    """The JAX models' padded batch: the least power of two times ``lo``
    that holds ``n`` rows (their random draws are made at this shape)."""
    m = lo
    while m < n:
        m *= 2
    return m


def compute_dtype(dtype):
    """The JAX models' ``dtype`` argument (``"f32"`` or ``"bf16"``) -> the
    nets' compute dtype."""
    return torch.bfloat16 if dtype in ("bf16", torch.bfloat16) else \
        torch.float32


class CheckpointModel(BaseModel):
    """A model over one net ``self.net`` (set by the subclass) on
    ``self.device``: checkpoints, the threefry key and the host-to-device
    copies.  ``device=None`` is the card (raises without one)."""

    def __init__(self, env, handle, name, subclass_name, device=None, seed=0):
        super().__init__(env, handle)
        self.name = name
        self.subclass_name = subclass_name
        self.device = resolve_device(device)
        # JAX: key, init_key = split(PRNGKey(seed)); the nets are drawn
        # from a torch generator seeded ``seed`` instead
        self.key = rnd.split(rnd.PRNGKey(seed, self.device))[0]

    # ------------------------------------------------------------ params
    def get_params(self):
        """The flat flax checkpoint of the online net (float32 NumPy)."""
        return params_to_flax(self.net)

    def set_params(self, flat):
        """Load a flat flax checkpoint into the online net, then restart
        training from it (target net, optimizer state)."""
        self.net.load_state_dict(params_from_flax(flat))
        self._restart_training()

    def _restart_training(self):
        raise NotImplementedError

    def save(self, dir_name, epoch):
        """save model to dir_name/name/subclass_epoch.npz"""
        dir_name = os.path.join(dir_name, self.name)
        os.makedirs(dir_name, exist_ok=True)  # nested paths, concurrent savers
        path = os.path.join(dir_name, self.subclass_name + "_%d.npz" % epoch)
        np.savez(path, **self.get_params())

    def load(self, dir_name, epoch=0, name=None):
        """load model; ``name`` allows restoring another model's weights"""
        name = name or self.name
        path = os.path.join(dir_name, name,
                            self.subclass_name + "_%d.npz" % epoch)
        with np.load(path) as flat:
            self.set_params(dict(flat))

    # ------------------------------------------------------- helpers
    def _next_key(self):
        """``self.key, sub = jax.random.split(self.key)`` -> ``sub``."""
        self.key, sub = rnd.split(self.key).unbind(0)
        return sub

    def _tensor(self, a, dtype=np.float32):
        """A host array on the model's device (a blocking copy)."""
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            self.device)

    def _egreedy(self, q, padded, eps):
        """The JAX models' in-graph e-greedy draw (``dqn.py:111-117``,
        ``drqn.py:190-196``) for Q values ``[n, n_act]`` of the live rows:
        ``k1, k2 = split(sub)``, ``randint(k1)`` where ``uniform(k2) <
        eps``, else the argmax; both drawn at the padded shape ``[padded]``
        and sliced to n.  -> int32 ``[n]`` on the device."""
        k1, k2 = rnd.split(self._next_key()).unbind(0)
        n = q.shape[0]
        best = q.argmax(1).to(torch.int32)
        rand = rnd.randint(k1, (padded,), 0, q.shape[1])[:n]
        explore = rnd.uniform(k2, (padded,))[:n] < float(np.float32(eps))
        return torch.where(explore, rand, best)
