"""Vectorized GridWorld: a batch of lockstep envs stepped as batched tensor
ops on one device (port of ``magent_tpu/parallel/vec_env.py``).

- every group runs at full capacity (``caps`` = exact initial populations);
- dead agents stay in their slot as masked entries; the reward rotation of
  ``clear_dead`` (``last <- next``, ``next <- step_reward``, reference
  GridWorld.h:168-174) is applied in place by :meth:`VecGridWorld.transition`;
- ``done`` envs auto-reset inside ``transition`` so batches never stall;
- with a ``mesh``, each ``dp`` rank holds a slice of the batch.

Keys are int64 ``[2]`` tensors of uint32 words (:mod:`magent_tpu_torch.random`),
bit-equal to ``jax.random`` keys, so the same key gives the same reset and
trajectory in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import random as rnd
from .. import spec as speclib
from ..config import Config
from ..core import engine, observe
from ..core.state import FIELDS, State
from ..spec import NORTH, OP_NULL
from ..spans import span


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: raise when there is none, never fall back to
    the CPU.  The CPU runs only when the caller names it."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: magent_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _wall_map(spec: speclib.GameSpec, walls=None):
    """Full [H, W] bool wall map: the border plus optional interior (x, y)
    cells.  The one construction site of both the reset's ``cell_wall`` and
    the step's packed wall grid, so the two cannot disagree
    (``vec_env.py:34-45``)."""
    H, W = spec.height, spec.width
    wall = np.zeros((H, W), bool)
    wall[0, :] = wall[-1, :] = wall[:, 0] = wall[:, -1] = True
    if walls is not None and len(walls):
        wxy = np.asarray(walls, np.int64)
        wall[wxy[:, 1], wxy[:, 0]] = True
    return wall


class VecGridWorld:
    """A batch of ``n_envs`` lockstep environments on ``device`` (default
    ``cuda``; raises without a card).

    ``placements``: per group, ``[n_g, 2 or 3]`` (x, y[, dir]) rows that
    fill the group's capacity exactly (required for multi-cell bodies; the
    facings are kept in turn mode, NORTH otherwise); otherwise agents are
    placed uniformly at random on free cells (facing at random in turn
    mode).
    ``obs_dtype``: the views' dtype, ``torch.bfloat16`` or ``None`` for
    f32 (``make_observe``'s ``obs_dtype``; the JAX package's bf16 views for
    its trainers, ``scripts/bench_train.py``).
    ``walls``: interior (x, y) wall cells shared by every env, added to
    the border (reference: test_1m.py's n/10 random walls).  The positional
    order is the JAX package's (``vec_env.py:177-178``).
    ``mesh``: a :func:`~magent_tpu_torch.parallel.sharding.make_mesh` mesh
    whose ``dp`` axis splits the ``n_envs`` envs; this rank then holds
    envs ``env_rows = (r0, r1)`` on the mesh's device, and every state,
    action and reward it takes or returns has ``n_local = r1 - r0`` rows.
    Its draws are made from the global key at the global shape and
    sliced, so each rank steps the same envs as an unsharded run does on
    those rows (the route is the unsharded batch's too)."""

    def __init__(self, config: Config, caps, n_envs: int, placements=None,
                 obs_dtype=None, walls=None, device=None, mesh=None):
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError("device %s is not the mesh's %s"
                                 % (device, mesh.device))
            device = mesh.device
            dp, i = mesh.shape["dp"], mesh.coord["dp"]
            if n_envs % dp:
                raise ValueError("%d envs do not split over dp=%d"
                                 % (n_envs, dp))
            r0 = i * (n_envs // dp)
            self.env_rows = (r0, r0 + n_envs // dp)
        else:
            self.env_rows = (0, n_envs)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.spec = spec = speclib.compile_spec(config, caps)
        self.n_envs = n_envs
        self.n_local = self.env_rows[1] - self.env_rows[0]
        wall = _wall_map(spec, walls)
        self._step = engine.make_step(spec, maintain_grid=False,
                                      n_envs=n_envs, walls=wall)
        obs_dtype = torch.float32 if obs_dtype is None else obs_dtype
        self._observe = [observe.make_observe(spec, g, obs_dtype)
                         for g in range(spec.n_groups)]
        # one grid pass shared by the groups (None in turn mode: the
        # rotating observation renders its own frame)
        self._grids = self._observe[0].grids_fn

        H, W, A = spec.height, spec.width, spec.n_agents_cap
        dev = self.device
        gof = spec.group_of_slot
        self._wall = torch.as_tensor(wall, device=dev)
        self._hp0 = torch.as_tensor(spec.g_hp_max[gof], device=dev)
        self._step_reward = torch.as_tensor(spec.s_step_reward, device=dev)
        self._n_action = torch.as_tensor(spec.s_n_action, device=dev)
        self._gof = torch.as_tensor(gof, dtype=torch.int64, device=dev)
        self._caps = torch.as_tensor([g.cap for g in spec.groups],
                                     dtype=torch.int32, device=dev)

        if placements is not None:
            sizes = [len(p) for p in placements]
            if sizes != [g.cap for g in spec.groups]:
                raise ValueError("placements must exactly fill group "
                                 "capacities %s, got %s"
                                 % ([g.cap for g in spec.groups], sizes))
            xs = np.concatenate([np.asarray(p)[:, 0] for p in placements])
            ys = np.concatenate([np.asarray(p)[:, 1] for p in placements])
            ds = np.full(A, NORTH, np.int32)
            if spec.turn_mode and np.asarray(placements[0]).shape[1] > 2:
                # the facings of the placements' third column
                # (vec_env.py:74-82)
                ds = np.concatenate([np.asarray(p)[:, 2] for p in placements])
            cell0 = np.full((H, W), -1, np.int32)
            cell0[ys, xs] = np.arange(A)
            if spec.max_body_w > 1:
                # every cell of a body rect, its facing's footprint
                # (vec_env.py:90-97)
                ns = (ds == NORTH) | (ds == speclib.SOUTH)
                bws = np.where(ns, spec.s_width, spec.s_length)
                bhs = np.where(ns, spec.s_length, spec.s_width)
                for s_, (xx, yy) in enumerate(zip(xs, ys)):
                    cell0[yy:yy + bhs[s_], xx:xx + bws[s_]] = s_
            self._placed = tuple(
                torch.as_tensor(a.astype(np.int32), device=dev)
                for a in (xs, ys, ds, cell0))
        else:
            if spec.max_body_w > 1:
                raise ValueError(
                    "random placement places 1x1 bodies only; pass explicit "
                    "placements for multi-cell agent types")
            n_free = int((~wall).sum())
            if A > n_free:
                raise ValueError(
                    "cannot place %d agents on a %dx%d map (%d free interior "
                    "cells)" % (A, H, W, n_free))
            self._placed = None

    # ------------------------------------------------------------ functional
    def _place(self, pkey):
        """Agent positions and facings for ``k`` envs -> (x, y, dir,
        cell_slot), int32."""
        spec = self.spec
        H, W, A = spec.height, spec.width, spec.n_agents_cap
        k = pkey.shape[0]
        if self._placed is not None:
            xs, ys, ds, cell0 = self._placed
            return (xs.expand(k, A), ys.expand(k, A), ds.expand(k, A),
                    cell0.expand(k, H, W))
        # uniform scores per free cell + stable argsort = a random
        # permutation of the free cells (reference: Map::get_random_blank,
        # Map.cc:49-63)
        scores = rnd.uniform(pkey, (H * W,))
        scores = torch.where(self._wall.reshape(-1), float("inf"), scores)
        cells = torch.argsort(scores, dim=-1, stable=True)[:, :A]
        slots = torch.arange(A, dtype=torch.int32, device=self.device)
        cell = torch.full((k, H * W), -1, dtype=torch.int32,
                          device=self.device).scatter_(
            1, cells, slots.expand(k, A))
        cells = cells.to(torch.int32)
        if spec.turn_mode:
            # random facings (vec_env.py:127-128)
            d = rnd.randint(rnd.fold_in(pkey, 1), (A,), 0, 4)
        else:
            d = torch.full((k, A), NORTH, dtype=torch.int32,
                           device=self.device)
        return cells % W, cells // W, d, cell.reshape(k, H, W)

    def _reset_keys(self, keys) -> State:
        """One fresh env per key of ``keys`` [k, 2] (the JAX package's
        per-env ``reset(key)``)."""
        spec = self.spec
        A, G = spec.n_agents_cap, spec.n_groups
        H, W = spec.height, spec.width
        dev = self.device
        k = keys.shape[0]
        pk = rnd.split(keys)  # [k, 2, 2]
        x, y, d, cell = self._place(pk[:, 0])

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return State(
            cell_slot=cell.contiguous(),
            cell_wall=self._wall.expand(k, H, W).clone(),
            cell_food=full((k, H, W), -1.0, torch.float32),
            x=x.contiguous(),
            y=y.contiguous(),
            dir=d.contiguous(),
            hp=self._hp0.expand(k, A).clone(),
            active=full((k, A), True, torch.bool),
            dead=full((k, A), False, torch.bool),
            absorbed=full((k, A), False, torch.bool),
            id=torch.arange(A, dtype=torch.int32, device=dev).expand(k, A).clone(),
            last_action=self._n_action.expand(k, A).clone(),
            next_reward=self._step_reward.expand(k, A).clone(),
            last_reward=full((k, A), 0.0, torch.float32),
            last_op=full((k, A), OP_NULL, torch.int32),
            op_obj=full((k, A), -1, torch.int32),
            group_reward=full((k, G), 0.0, torch.float32),
            n_in_group=self._caps.expand(k, G).clone(),
            lcg=full((k,), 1, torch.int64),
            key=pk[:, 1].contiguous(),
            done=full((k,), False, torch.bool),
            id_counter=full((k,), A, torch.int32),
            step_ct=full((k,), 0, torch.int32),
        )

    def local_rows(self, t):
        """Rows ``env_rows`` of a draw ``t`` made at the global batch
        (``t`` itself when this venv holds every env)."""
        r0, r1 = self.env_rows
        return t if (r0, r1) == (0, self.n_envs) else t[r0:r1]

    def reset(self, key) -> State:
        """key [2] -> batched State (``jax.random.split(key, n_envs)``, one
        env per subkey; this venv's ``env_rows`` of them)."""
        return self._reset_keys(self.local_rows(
            rnd.split(key.to(self.device), self.n_envs)))

    def observe(self, state: State, group: int, grids=None):
        """-> (views [B, cap, vh, vw, C], feats [B, cap, F])."""
        with span("env.observe"):
            return self._observe[group](state, grids)

    def observe_all(self, state: State):
        """Observations for every group, sharing one grid-render pass (none
        in turn mode)."""
        with span("env.observe"):
            grids = self._grids(state) if self._grids is not None else None
            return [obs(state, grids) for obs in self._observe]

    def step(self, state: State, actions) -> State:
        """Advance every env one step; ``actions`` is [B, A] over the full
        slot axis."""
        return self._step(state, actions)

    def transition(self, state: State, actions):
        """step + reward extraction + per-step reward rotation + auto-reset.

        Returns (next_state, rewards [B, A], alive [B, A], done [B]);
        ``rewards``/``alive`` are reported before the auto-reset, per slot,
        with the group reward broadcast in (GridWorld.cc:694-704)."""
        with span("env.transition"):
            stepped = self.step(state, actions)
            rewards = stepped.next_reward + stepped.group_reward[:, self._gof]
            alive = stepped.active & ~stepped.dead
            done = stepped.done

            # reward rotation normally done by clear_dead
            # (GridWorld.h:168-174); last_reward (the obs feature) is the
            # individual reward only
            nxt = stepped.replace(
                last_reward=stepped.next_reward,
                next_reward=torch.where(alive, self._step_reward, 0.0),
                group_reward=torch.zeros_like(stepped.group_reward),
                last_op=torch.full_like(stepped.last_op, OP_NULL),
                op_obj=torch.full_like(stepped.op_obj, -1),
            )

            # auto-reset finished envs from their carried keys; episodes end
            # rarely, so the reset runs only when some env is done (one host
            # sync per step reads that flag)
            if bool(done.any()):
                idx = torch.nonzero(done)[:, 0]
                fresh = self._reset_keys(rnd.fold_in(stepped.key[idx], 7))
                merged = {}
                for name in FIELDS:
                    t = getattr(nxt, name).clone()
                    t[idx] = getattr(fresh, name)
                    merged[name] = t
                nxt = State(**merged)
            return nxt, rewards, alive, done

    def random_actions(self, key, fast: bool = False):
        """Uniform random action per slot, valid for each slot's group ->
        [B, A] int32 (this venv's rows of the global draw).  ``fast=True``
        replaces the threefry draw with a SplitMix mix of (key words,
        global env index, slot) (vec_env.py:283-312)."""
        A = self.spec.n_agents_cap
        key = key.to(self.device)
        if fast:
            env = torch.arange(*self.env_rows, dtype=torch.int64,
                               device=self.device)
            lane = (rnd.mul32(env, 0x632BE59B)[:, None]
                    + torch.arange(A, dtype=torch.int64,
                                   device=self.device)) & rnd.MASK32
            kd = key.reshape(-1)
            # mix all key words (keys differing only in the high word must
            # not collide)
            seed = kd[-1]
            for w in range(kd.shape[0] - 1):
                seed = (rnd.mul32(seed, 0x9E3779B9) + kd[w]) & rnd.MASK32
            z = rnd.splitmix_finalize(
                (seed + rnd.mul32(lane, 0x9E3779B9)) & rnd.MASK32)
            u = (z >> 8).to(torch.float32) * (1.0 / (1 << 24))
        else:
            u = self.local_rows(rnd.uniform(key, (self.n_envs, A)))
        return (u * self._n_action).to(torch.int32)

    # ------------------------------------------------------------------ info
    def action_spaces(self):
        return [self.spec.action_space(g) for g in range(self.spec.n_groups)]

    def view_spaces(self):
        return [self.spec.view_space(g) for g in range(self.spec.n_groups)]

    def feature_spaces(self):
        return [(self.spec.feature_size(g),) for g in range(self.spec.n_groups)]
