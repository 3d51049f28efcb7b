"""Batched environment state: a dataclass of fixed-capacity masked tensors.

Same fields as ``magent_tpu/core/state.py:24-57`` with a leading env axis B
written out (no vmap): grids ``[B, H, W]``, per-slot arrays ``[B, A]``,
per-group arrays ``[B, G]``, scalars ``[B]`` and the threefry key ``[B, 2]``.
uint32 fields (``lcg``, ``key``) are held as int64 words (see
:mod:`magent_tpu_torch.random`).

``state_from_numpy`` / ``state_to_numpy`` carry a state across packages: a
JAX ``State`` turned into a dict of numpy arrays (``np.asarray`` per field,
with a leading axis added for a single world) becomes a port state and back,
so both packages can step the same state.  :func:`init_state` is the fresh
single world (B = 1) of the stateful ``GridWorld``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import random as rnd
from .. import spec as speclib
from . import lcg


@dataclasses.dataclass
class State:
    # grid (indexed [b, y, x])
    cell_slot: torch.Tensor  # int32 [B, H, W], occupying slot or -1 (the
    # gridless path neither reads nor rebuilds it)
    cell_wall: torch.Tensor  # bool [B, H, W]
    cell_food: torch.Tensor  # float32 [B, H, W], -1 = none

    # agents (capacity A)
    x: torch.Tensor  # int32 [B, A], stored top-left of the body rect
    y: torch.Tensor  # int32 [B, A]
    dir: torch.Tensor  # int32 [B, A], EAST=0 SOUTH=1 WEST=2 NORTH=3
    hp: torch.Tensor  # float32 [B, A]
    active: torch.Tensor  # bool [B, A]
    dead: torch.Tensor  # bool [B, A]
    absorbed: torch.Tensor  # bool [B, A]
    id: torch.Tensor  # int32 [B, A]
    last_action: torch.Tensor  # int32 [B, A]
    next_reward: torch.Tensor  # float32 [B, A]
    last_reward: torch.Tensor  # float32 [B, A]
    last_op: torch.Tensor  # int32 [B, A]
    op_obj: torch.Tensor  # int32 [B, A]

    # groups
    group_reward: torch.Tensor  # float32 [B, G]
    n_in_group: torch.Tensor  # int32 [B, G]

    # rng / episode
    lcg: torch.Tensor  # int64 [B], uint32 minstd state (host placement RNG)
    key: torch.Tensor  # int64 [B, 2], uint32 threefry key words
    done: torch.Tensor  # bool [B]
    id_counter: torch.Tensor  # int32 [B]
    step_ct: torch.Tensor  # int32 [B]

    def replace(self, **changes) -> "State":
        return dataclasses.replace(self, **changes)


FIELDS = tuple(f.name for f in dataclasses.fields(State))
_UINT32_FIELDS = ("lcg", "key")


def state_from_numpy(arrays: dict, device) -> State:
    """Batched numpy arrays keyed by field name -> :class:`State` on
    ``device``.  uint32 fields widen to int64 words."""
    missing = set(FIELDS) - set(arrays)
    if missing:
        raise ValueError("missing state fields: %s" % sorted(missing))
    out = {}
    for name in FIELDS:
        arr = np.asarray(arrays[name])
        if name in _UINT32_FIELDS:
            arr = arr.astype(np.int64)
        out[name] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return State(**out)


def state_to_numpy(state: State) -> dict:
    """:class:`State` -> dict of numpy arrays with the JAX package's dtypes
    (uint32 for ``lcg`` and ``key``)."""
    out = {}
    for name in FIELDS:
        arr = getattr(state, name).cpu().numpy()
        if name in _UINT32_FIELDS:
            arr = arr.astype(np.uint32)
        out[name] = arr
    return out


def init_state(spec: speclib.GameSpec, device, seed: int | None = None) -> State:
    """Fresh empty single world (B = 1): border walls only (reference:
    Map.cc:39-46), as ``magent_tpu/core/state.py:60-94``."""
    H, W, A, G = spec.height, spec.width, spec.n_agents_cap, spec.n_groups
    seed = spec.seed if seed is None else seed

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    wall = full((1, H, W), False, torch.bool)
    wall[:, 0, :] = wall[:, H - 1, :] = True
    wall[:, :, 0] = wall[:, :, W - 1] = True
    return State(
        cell_slot=full((1, H, W), -1, torch.int32),
        cell_wall=wall,
        cell_food=full((1, H, W), -1.0, torch.float32),
        x=full((1, A), 0, torch.int32),
        y=full((1, A), 0, torch.int32),
        dir=full((1, A), speclib.NORTH, torch.int32),
        hp=full((1, A), 0.0, torch.float32),
        active=full((1, A), False, torch.bool),
        dead=full((1, A), False, torch.bool),
        absorbed=full((1, A), False, torch.bool),
        id=full((1, A), 0, torch.int32),
        last_action=full((1, A), 0, torch.int32),
        next_reward=full((1, A), 0.0, torch.float32),
        last_reward=full((1, A), 0.0, torch.float32),
        last_op=full((1, A), speclib.OP_NULL, torch.int32),
        op_obj=full((1, A), -1, torch.int32),
        group_reward=full((1, G), 0.0, torch.float32),
        n_in_group=full((1, G), 0, torch.int32),
        lcg=full((1,), int(lcg.seed_state(seed)), torch.int64),
        key=rnd.PRNGKey(seed, device)[None],
        done=full((1,), False, torch.bool),
        id_counter=full((1,), 0, torch.int32),
        step_ct=full((1,), 0, torch.int32),
    )
