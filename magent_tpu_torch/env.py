"""Stateful GridWorld with the reference Python API (port of
``magent_tpu/env.py``).

Drop-in surface of the reference's ctypes wrapper
(reference: python/magent/gridworld.py:14-490): construction from a builtin
config name or a :class:`Config`, group handles, ``get_observation`` /
``set_action`` / ``step`` / ``get_reward`` / ``clear_dead`` and the info
getters.  Underneath, the state is the port's batched :class:`State` with
one world (B = 1) on ``device`` (the GPU unless the caller names the CPU),
stepped by the engine's grid path; agent and wall placement run on the host
with the reference's LCG, so a seed places the same cells as the JAX
package.  ``engine_mode="sequential"`` steps the reference C++ engine's
order instead (:mod:`core.seq_engine`, host NumPy): the state goes to the
host and back once per step, and the observation stays on ``device``.

Fixed capacities grow on demand (powers of two from 256); growth rebuilds
the step and observation functions for the new slot layout.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

from . import random as rnd
from . import spec as speclib
from .config import Config
from .core import engine, lcg, observe
from .core import geometry as geo
from .core.seq_engine import SequentialEngine
from .core.state import State, init_state
from .environment import Environment
from .parallel.vec_env import resolve_device
from .render.generator import (COLORS, FRAME_FIELDS, RenderGenerator,
                               attack_events, to_host)
from .spec import NORTH, OP_NULL

# per-slot state fields carried across a capacity change
_SLOT_FIELDS = (
    "x", "y", "dir", "hp", "active", "dead", "absorbed", "id",
    "last_action", "next_reward", "last_reward", "last_op", "op_obj",
)
# the fields the sequential engine reads (``SequentialEngine.step``'s ``S``),
# and those of them it writes back (with ``last_action``, ``done``)
_SEQ_READ = (
    "x", "y", "dir", "hp", "active", "dead", "absorbed", "next_reward",
    "last_op", "op_obj", "id", "cell_slot", "cell_wall", "cell_food",
    "group_reward",
)
_SEQ_WRITE = (
    "x", "y", "dir", "hp", "dead", "absorbed", "next_reward", "last_op",
    "op_obj", "cell_slot", "cell_food", "group_reward",
)


def _to_host(tensors, device):
    """Row 0 of each tensor as a writable numpy array of its own.  On the
    GPU: one asynchronous copy each into pinned memory, then one wait."""
    if device.type != "cuda":
        return [t[0].numpy().copy() for t in tensors]
    out = [t[0].to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(device).synchronize()
    return [o.numpy() for o in out]


def _to_device(arrays, device):
    """Numpy arrays -> tensors on ``device`` with a leading axis of 1 and
    their own dtypes, in one host-to-device copy: their bytes are packed
    into one buffer (each padded to 8 bytes; pinned, and copied without a
    wait, on the GPU) and the tensors are views of it on the device."""
    parts, spans, off = [], [], 0
    for a in arrays:
        raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        pad = -len(raw) % 8
        parts.append(raw)
        if pad:
            parts.append(np.zeros(pad, np.uint8))
        spans.append(off)
        off += len(raw) + pad
    buf = torch.from_numpy(np.concatenate(parts))
    if device.type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    out = []
    for a, start in zip(arrays, spans):
        dtype = torch.from_numpy(a[:0]).dtype
        t = buf[start:start + a.nbytes].view(dtype)
        out.append(t.reshape((1,) + a.shape))
    return out


class Handle:
    """Group handle with a ``.value`` attribute like ``ctypes.c_int32``."""

    def __init__(self, value: int):
        self.value = value

    def __index__(self):
        return self.value

    def __int__(self):
        return self.value

    def __repr__(self):
        return "Handle(%d)" % self.value


class GridWorld(Environment):
    OBS_INDEX_VIEW = 0
    OBS_INDEX_HP = 1

    def __init__(self, config, caps: int | list | None = None,
                 engine_mode="fast", device=None, **kwargs):
        if isinstance(config, str):
            try:
                mod = importlib.import_module(
                    "magent_tpu_torch.builtin.config." + config)
            except ImportError:
                raise BaseException('unknown built-in game "%s"' % config)
            config = getattr(mod, "get_config")(**kwargs)
        assert isinstance(config, Config)
        assert engine_mode in ("fast", "sequential")
        super().__init__()

        self.device = resolve_device(device)
        self._config = config
        self._engine_mode = engine_mode
        self._seq = None  # SequentialEngine of the current spec
        self._dead_ct = None  # its per-group death counts (host)
        # the sequential engine's exact attack events of the last step;
        # None until a sequential step sets it (the render then
        # reconstructs them, render/generator.py attack_events)
        self._last_attack_events = None
        self._caps = self._initial_caps(config, caps)
        self._lcg = lcg.HostLCG(int(config.config_dict.get("seed", 0)))
        self._render_dir = None
        self._render_gen = None
        self._render_reset_ct = 0  # resets before the generator exists
        self._first_render = True
        # the reference records per-step attack events only after rendering
        # was activated by the first render()/render_window_info call
        # (GridWorld.cc:18,484,798,944) — never reset by reset()
        self._render_ever = False
        self._attack_events = np.zeros((0, 3), np.int32)
        self._pre_step_dead = None
        self._goals = {}

        self._build(self._caps)
        self.state = init_state(self.spec, self.device)

        self.group_handles = [Handle(i) for i in range(self.spec.n_groups)]
        self._refresh_spaces()

    # ------------------------------------------------------------- state
    @property
    def state(self) -> State:
        return self._state

    @state.setter
    def state(self, state: State):
        # the host copy of n_in_group is read lazily; every new state may
        # change it except a step's (see step())
        self._state = state
        self._n_host = None

    def _counts(self) -> np.ndarray:
        if self._n_host is None:
            self._n_host = self._state.n_in_group[0].cpu().numpy()
        return self._n_host

    def _lcg_tensor(self):
        return torch.tensor([int(self._lcg.state)], dtype=torch.int64,
                            device=self.device)

    # ------------------------------------------------------------- build
    @staticmethod
    def _initial_caps(config, caps):
        n_groups = len(config.groups)
        if caps is None:
            return [256] * n_groups
        if isinstance(caps, int):
            return [caps] * n_groups
        return list(caps)

    def _build(self, caps):
        self.spec = speclib.compile_spec(self._config, caps)
        sp = self.spec
        self._step_fn = engine.make_step(sp)
        self._clear_fn = engine.make_clear_dead(sp)
        self._observe_fns = [observe.make_observe(sp, g)
                             for g in range(sp.n_groups)]
        # one grid-render pass serves every group's get_observation of a
        # step; turn mode has none (env.py:113-115): each group's rotating
        # observation renders its own frame
        self._grids_fn = self._observe_fns[0].grids_fn
        self._grids_cache = None  # (state object, grids)
        self._actions = np.zeros(sp.n_agents_cap, np.int32)

    def _refresh_spaces(self):
        self.view_space = {h.value: self.spec.view_space(h.value)
                           for h in self.group_handles}
        self.feature_space = {h.value: (self.spec.feature_size(h.value),)
                              for h in self.group_handles}
        self.action_space = {h.value: self.spec.action_space(h.value)
                             for h in self.group_handles}

    def _grow(self, group: int, needed: int):
        """Grow a group's capacity and migrate state (slot indices shift)."""
        caps = list(self._caps)
        while caps[group] < needed:
            caps[group] = max(2 * caps[group], 256)
        self._migrate(caps)

    def _migrate(self, caps):
        """Rebuild the spec with new ``caps`` (possibly with a newly
        appended group) and migrate the live state into it."""
        old_spec, old = self.spec, self.state
        old_actions = self._actions
        self._caps = caps
        self._build(caps)
        new = init_state(self.spec, self.device)
        moves = [(self.spec.groups[g].offset, old_spec.groups[g].offset,
                  old_spec.groups[g].cap) for g in range(old_spec.n_groups)]

        def seg_copy(new_t, old_t):
            new_t = new_t.clone()
            for n_off, o_off, cap in moves:
                new_t[:, n_off:n_off + cap] = old_t[:, o_off:o_off + cap]
            return new_t

        def head_copy(new_t, old_t):  # new_group appends a group
            new_t = new_t.clone()
            new_t[:, :old_t.shape[1]] = old_t
            return new_t

        new = new.replace(
            **{f: seg_copy(getattr(new, f), getattr(old, f))
               for f in _SLOT_FIELDS},
            cell_wall=old.cell_wall, cell_food=old.cell_food,
            group_reward=head_copy(new.group_reward, old.group_reward),
            n_in_group=head_copy(new.n_in_group, old.n_in_group),
            lcg=old.lcg, key=old.key, done=old.done,
            id_counter=old.id_counter, step_ct=old.step_ct)
        self.state = new.replace(cell_slot=self._rebuild_grid(new))
        for n_off, o_off, cap in moves:
            self._actions[n_off:n_off + cap] = old_actions[o_off:o_off + cap]
        # group count or channel layout may have changed
        self._refresh_spaces()

    def _rebuild_grid(self, state: State):
        """Occupancy grid from the agents' positions (live agents only)."""
        sp = self.spec
        H, W, A = sp.height, sp.width, sp.n_agents_cap
        gof = torch.as_tensor(sp.group_of_slot, dtype=torch.int64,
                              device=self.device)
        w = torch.as_tensor(sp.g_width, device=self.device)[gof]
        l = torch.as_tensor(sp.g_length, device=self.device)[gof]
        ns = (state.dir == NORTH) | (state.dir == speclib.SOUTH)
        bw, bh = torch.where(ns, w, l), torch.where(ns, l, w)
        mask = state.active & ~state.dead
        slots = torch.arange(A, dtype=torch.int32, device=self.device)
        flat = torch.full((1, H * W + 1), -1, dtype=torch.int32,
                          device=self.device)
        for i in range(sp.max_body_w):
            for j in range(sp.max_body_w):
                ok = mask & (i < bw) & (j < bh)
                cell = torch.where(ok, (state.y + j) * W + state.x + i, H * W)
                flat = flat.scatter(1, cell.long(), slots[None].expand(1, A))
        return flat[:, :H * W].reshape(1, H, W)

    # -------------------------------------------------------------- game
    def reset(self):
        """Reset map and agents; the engine RNG persists across resets
        (reference: GridWorld::reset never reseeds, GridWorld.cc:72-118)."""
        carry_key = self.state.key
        self.state = init_state(self.spec, self.device).replace(
            key=carry_key, lcg=self._lcg_tensor())
        self._actions[:] = 0
        if self._dead_ct is not None:
            self._dead_ct[:] = 0
        self._first_render = True
        # the reference bumps the video file number on EVERY reset
        # (GridWorld.cc:97 render_generator.next_file()), so the first
        # episode dumps video_1.txt, the second video_2.txt, ...
        if self._render_gen is not None:
            self._render_gen.next_file()
        else:
            self._render_reset_ct += 1

    def set_seed(self, seed):
        self._lcg.seed(seed)
        self.state = self.state.replace(
            lcg=self._lcg_tensor(),
            key=rnd.PRNGKey(int(seed), self.device)[None])

    # ------------------------------------------------------------ agents
    def new_group(self, name):
        """Create a new (empty) group of the registered agent type ``name``
        and return its handle (reference: gridworld.py:144-147).  Every
        group's view space grows by ``channel_scale`` channels, as if the
        game had been built with the extra group declared."""
        if name not in self._config.agent_type_dict:
            raise KeyError("unknown agent type %r" % (name,))
        self._config.add_group(name)
        handle = Handle(len(self._config.groups) - 1)
        self.group_handles.append(handle)
        self._migrate(list(self._caps) + [256])
        if self._dead_ct is not None:
            self._dead_ct = np.append(self._dead_ct, 0)
        return handle

    def add_walls(self, method, **kwargs):
        kwargs["dir"] = 0
        self.add_agents(-1, method, **kwargs)

    def _host_blocked(self):
        st = self.state
        occ = st.cell_slot[0].cpu().numpy()
        wall = st.cell_wall[0].cpu().numpy().copy()
        food = st.cell_food[0].cpu().numpy()
        return wall | (occ >= 0) | (food >= 0), wall

    def add_agents(self, handle, method, **kwargs):
        group = handle.value if isinstance(handle, Handle) else int(handle)
        sp = self.spec
        H, W = sp.height, sp.width
        blocked, wall = self._host_blocked()

        if group == -1:  # walls (reference: GridWorld.cc:184-217)
            new_wall = wall.copy()
            if method == "random":
                for _ in range(int(kwargs["n"])):
                    x, y = self._random_blank(blocked, 1, 1)
                    new_wall[y, x] = blocked[y, x] = True
            elif method == "custom":
                for p in kwargs["pos"]:
                    x, y = int(p[0]), int(p[1])
                    if not (0 <= x < W and 0 <= y < H):
                        continue
                    if blocked[y, x] and not new_wall[y, x]:
                        continue  # occupied by agent/food: ignored with warning
                    new_wall[y, x] = blocked[y, x] = True
            elif method == "fill":
                x0, y0 = int(kwargs["pos"][0]), int(kwargs["pos"][1])
                fw, fh = int(kwargs["size"][0]), int(kwargs["size"][1])
                for x in range(x0, x0 + fw):
                    for y in range(y0, y0 + fh):
                        if 0 <= x < W and 0 <= y < H and not (
                                blocked[y, x] and not new_wall[y, x]):
                            new_wall[y, x] = blocked[y, x] = True
            else:
                raise ValueError("unsupported add_walls method " + str(method))
            self.state = self.state.replace(cell_wall=torch.tensor(
                new_wall[None], device=self.device))
            return

        t = sp.groups[group].type
        placements = []  # (x, y, dir)

        def body_wh(d):
            return geo.size_for_dir_np(d, t.width, t.length)

        def rect_blank(x, y, bw, bh):
            if x < 0 or y < 0 or x + bw >= W or y + bh >= H:
                return False
            return not blocked[y:y + bh, x:x + bw].any()

        if method == "random":
            for _ in range(int(kwargs["n"])):
                d = (self._lcg() % 4) if sp.turn_mode else NORTH
                bw, bh = body_wh(d)
                x, y = self._random_blank(blocked, bw, bh)
                blocked[y:y + bh, x:x + bw] = True
                placements.append((x, y, d))
        elif method == "custom":
            for p in kwargs["pos"]:
                x, y = int(p[0]), int(p[1])
                if len(p) > 2 and not 0 <= int(p[2]) < 4:
                    # validated even with turn_mode off, like the reference
                    # (LOG(FATAL), GridWorld.cc:249-251)
                    raise ValueError(
                        "invalid direction in add_agents: %r" % (p[2],))
                d = int(p[2]) if len(p) > 2 and sp.turn_mode else NORTH
                bw, bh = body_wh(d)
                if not rect_blank(x, y, bw, bh):
                    continue  # reference warns and ignores
                blocked[y:y + bh, x:x + bw] = True
                placements.append((x, y, d))
        elif method == "fill":
            x0, y0 = int(kwargs["pos"][0]), int(kwargs["pos"][1])
            fw, fh = int(kwargs["size"][0]), int(kwargs["size"][1])
            d = int(kwargs.get("dir", 0)) if sp.turn_mode else NORTH
            bw, bh = body_wh(d)
            for x in range(x0, x0 + fw, bw):
                for y in range(y0, y0 + fh, bh):
                    if not rect_blank(x, y, bw, bh):
                        continue
                    blocked[y:y + bh, x:x + bw] = True
                    placements.append((x, y, d))
        else:
            raise ValueError("unknown method " + str(method))

        self._commit_agents(group, placements)

    def _random_blank(self, blocked, bw, bh):
        """Rejection sampling with the engine LCG (reference: Map.cc:49-63)."""
        H, W = blocked.shape
        tries = 0
        while True:
            x = self._lcg() % (W - bw)
            y = self._lcg() % (H - bh)
            if x + bw < W and y + bh < H and not blocked[y:y + bh, x:x + bw].any():
                return x, y
            tries += 1
            if tries > W * H:
                raise RuntimeError("cannot find a blank position in a filled map")

    def _commit_agents(self, group, placements):
        n_new = len(placements)
        if n_new == 0:
            return
        n_cur = int(self._counts()[group])
        if n_cur + n_new > self.spec.groups[group].cap:
            self._grow(group, n_cur + n_new)
        sp = self.spec
        gspec = sp.groups[group]
        t = gspec.type
        slots = np.arange(n_cur, n_cur + n_new) + gspec.offset
        xs, ys, ds = (np.asarray(c, np.int32) for c in zip(*placements))
        st = self.state
        id0 = int(st.id_counter[0])
        idx = torch.as_tensor(slots, device=self.device)

        def put(tensor, values):
            out = tensor.clone()
            out[0, idx] = torch.as_tensor(values, dtype=out.dtype,
                                          device=self.device)
            return out

        n_in_group = st.n_in_group.clone()
        n_in_group[0, group] += n_new
        # fill the occupancy grid (body rects) in one scatter
        cys, cxs, vals = [], [], []
        for k, (x, y, d) in enumerate(placements):
            bw, bh = geo.size_for_dir_np(d, t.width, t.length)
            for i in range(bw):
                for j in range(bh):
                    cxs.append(x + i)
                    cys.append(y + j)
                    vals.append(slots[k])
        cell = st.cell_slot.clone()
        cell[0, torch.as_tensor(cys, device=self.device),
             torch.as_tensor(cxs, device=self.device)] = torch.as_tensor(
            np.asarray(vals, np.int32), device=self.device)
        self.state = st.replace(
            x=put(st.x, xs), y=put(st.y, ys), dir=put(st.dir, ds),
            hp=put(st.hp, t.hp),
            active=put(st.active, True), dead=put(st.dead, False),
            absorbed=put(st.absorbed, False),
            id=put(st.id, np.arange(id0, id0 + n_new, dtype=np.int32)),
            # "dangerous here": fresh agents' last_action = n_action
            # (reference: GridWorld.h:140) -> one-hot encodes to zeros
            last_action=put(st.last_action, t.n_action),
            next_reward=put(st.next_reward, t.step_reward),
            last_reward=put(st.last_reward, 0.0),
            last_op=put(st.last_op, OP_NULL),
            op_obj=put(st.op_obj, -1),
            n_in_group=n_in_group,
            id_counter=torch.full_like(st.id_counter, id0 + n_new),
            cell_slot=cell,
        )

    # --------------------------------------------------------------- run
    def get_observation(self, handle):
        g = handle.value
        grids = None
        if self._grids_fn is not None:
            if self._grids_cache is None or \
                    self._grids_cache[0] is not self.state:
                self._grids_cache = (self.state, self._grids_fn(self.state))
            grids = self._grids_cache[1]
        view, feat = self._observe_fns[g](self.state, grids)
        n = self.get_num(handle)
        return view[0, :n].cpu().numpy(), feat[0, :n].cpu().numpy()

    def set_action(self, handle, actions):
        assert isinstance(actions, np.ndarray)
        assert actions.dtype == np.int32
        off = self.spec.groups[handle.value].offset
        n = self.get_num(handle)
        self._actions[off:off + n] = actions[:n]

    def step(self):
        # pre-step liveness: get_both_attack counts no agent that was
        # already dead before this step (state tensors are never updated in
        # place, so a reference is a snapshot)
        self._pre_step_dead = self.state.dead
        counts = self._n_host
        if self._engine_mode == "sequential":
            done = self._step_sequential()
        else:
            self.state = self._step_fn(self.state, torch.tensor(
                self._actions[None], device=self.device))
            done = bool(self.state.done[0])
        self._n_host = counts  # a step never changes n_in_group
        return done

    def _step_sequential(self):
        """Reference-order parity step: row 0 of the state to the host, one
        :meth:`SequentialEngine.step` there, the changed fields back to the
        device (``magent_tpu/env.py`` ``_step_sequential``)."""
        if self._seq is None or self._seq.spec is not self.spec:
            self._seq = SequentialEngine(self.spec)
        if self._dead_ct is None:
            self._dead_ct = np.zeros(self.spec.n_groups, np.int64)
        st = self.state
        S = dict(zip(_SEQ_READ, _to_host(
            [getattr(st, f) for f in _SEQ_READ], self.device)))
        S["last_action"] = self._actions.copy()
        S["dead_ct"] = self._dead_ct
        done = bool(self._seq.step(S, self._lcg))
        # the exact event list (the fast engine's render reconstructs it)
        self._last_attack_events = list(self._seq.attack_events)
        new = _to_device([S[f] for f in _SEQ_WRITE]
                         + [self._actions, np.array([done])], self.device)
        self.state = st.replace(
            **dict(zip(_SEQ_WRITE, new[:-2])), last_action=new[-2],
            done=new[-1][0], lcg=self._lcg_tensor(), step_ct=st.step_ct + 1)
        return done

    def get_reward(self, handle):
        g = handle.value
        off = self.spec.groups[g].offset
        n = self.get_num(handle)
        st = self.state
        return (st.next_reward[0, off:off + n]
                + st.group_reward[0, g]).cpu().numpy()

    def clear_dead(self):
        self.state = self._clear_fn(self.state)
        if self._dead_ct is not None:
            self._dead_ct[:] = 0

    # -------------------------------------------------------------- info
    def get_handles(self):
        return self.group_handles

    def get_num(self, handle):
        return int(self._counts()[handle.value])

    def get_action_space(self, handle):
        return self.action_space[handle.value]

    def get_view_space(self, handle):
        return self.view_space[handle.value]

    def get_feature_space(self, handle):
        return self.feature_space[handle.value]

    def _group_slice(self, handle):
        off = self.spec.groups[handle.value].offset
        return slice(off, off + self.get_num(handle))

    def _host(self, name, handle):
        return getattr(self.state, name)[0, self._group_slice(handle)].cpu().numpy()

    def get_agent_id(self, handle):
        return self._host("id", handle).astype(np.int32)

    def get_alive(self, handle):
        return ~self._host("dead", handle)

    def get_pos(self, handle):
        return np.stack([self._host("x", handle), self._host("y", handle)],
                        axis=1).astype(np.int32)

    def get_mean_info(self, handle):
        n_action = self.action_space[handle.value][0]
        xs = self._host("x", handle).astype(np.float64)
        ys = self._host("y", handle).astype(np.float64)
        acts = self._host("last_action", handle)
        # fresh agents carry the sentinel last_action == n_action
        # (GridWorld.h:140 "dangerous here"); the reference's histogram
        # write is out of bounds for them (GridWorld.cc:777-779), so they
        # are dropped from the counts (the divisor stays the population)
        hist = np.bincount(acts[acts < n_action], minlength=n_action)
        n = max(len(xs), 1)
        out = np.empty(2 + n_action, np.float32)
        out[0] = xs.mean() if len(xs) else 0.0
        out[1] = ys.mean() if len(ys) else 0.0
        out[2:] = hist / n
        return out

    def get_view2attack(self, handle):
        t = self.spec.groups[handle.value].type
        return t.attack_base, t.view2attack()

    def get_both_attack(self):
        """Count of targets attacked by more than one agent last step: an
        attack counts only where it found a live object (GridWorld.cc:487-495),
        i.e. ``last_op`` in {ATTACK, KILL} with ``op_obj`` the target's slot
        (see ``magent_tpu/env.py`` ``get_both_attack``)."""
        st = self.state
        last_op = st.last_op[0].cpu().numpy()
        op_obj = st.op_obj[0].cpu().numpy()
        active = st.active[0].cpu().numpy()
        pre_dead = self._pre_step_dead
        if pre_dead is None or pre_dead.shape[1] != len(last_op):
            pre_dead = st.dead
        pre_dead = pre_dead[0].cpu().numpy()
        counts = {}
        for g in self.spec.groups:
            t = g.type
            sl = slice(g.offset, g.offset + g.cap)
            act = self._actions[sl]
            landed = (last_op[sl] == speclib.OP_ATTACK) | (
                last_op[sl] == speclib.OP_KILL)
            is_attack = (
                active[sl] & ~pre_dead[sl] & landed
                & (act >= t.attack_base) & (act < t.n_action)
                & (op_obj[sl] >= 0)
            )
            for k in np.nonzero(is_attack)[0]:
                tgt = int(op_obj[g.offset + k])
                counts[tgt] = counts.get(tgt, 0) + 1
        return sum(1 for v in counts.values() if v > 1)

    def get_global_minimap(self, height, width):
        sp = self.spec
        G = sp.n_groups
        out = np.zeros((height, width, G), np.float32)
        scale_h = (sp.height + height - 1) // height
        scale_w = (sp.width + width - 1) // width
        for i in range(G):
            channel = (i + 1) % G  # reference called with group=-1
            handle = self.group_handles[i]
            xs = self._host("x", handle) // scale_w
            ys = self._host("y", handle) // scale_h
            np.add.at(out[:, :, channel], (ys, xs), 1.0)
            out[:, :, channel] /= max(len(xs), 1)
        return out

    # ------------------------------------------------------------ render
    def set_render_dir(self, name):
        os.makedirs(name, exist_ok=True)
        self._render_dir = name

    def render(self):
        """Append one replay frame to ``video_<k>.txt`` of the render
        directory (``config.json`` at the first frame of an episode)."""
        if self._render_gen is None:
            self._render_gen = RenderGenerator(self._render_dir or "render")
            self._render_gen.file_ct = self._render_reset_ct
        if self._first_render:
            self._first_render = False
            self._render_gen.gen_config(self)
        self._render_gen.render_a_frame(self, include_events=self._render_ever)
        self._render_ever = True

    def _frame_host(self, wall=False):
        """Row 0 of the fields a replay frame or a render query reads
        (``FRAME_FIELDS``), the pre-step liveness ``pre_dead``,
        ``n_in_group`` and, with ``wall``, ``cell_wall`` as ``wall``: NumPy
        arrays from one copy to the host.  The group counts are kept for
        ``get_num``."""
        st = self.state
        pre = self._pre_step_dead
        if pre is None or pre.shape[1] != st.dead.shape[1]:
            pre = st.dead  # no snapshot (e.g. render before any step)
        names = FRAME_FIELDS + ("pre_dead", "n_in_group")
        tensors = [getattr(st, f)[0] for f in FRAME_FIELDS] + [
            pre[0], st.n_in_group[0]]
        if wall:
            names += ("wall",)
            tensors.append(st.cell_wall[0])
        host = dict(zip(names, to_host(tensors)))
        if self._n_host is None:
            self._n_host = host["n_in_group"]
        return host

    def _get_groups_info(self):
        sp = self.spec
        out = np.empty((sp.n_groups, 5), np.int32)
        for i, g in enumerate(sp.groups):
            out[i, 0] = g.type.width
            out[i, 1] = g.type.length
            out[i, 2:5] = COLORS[i % len(COLORS)]
        return out

    def _get_walls_info(self):
        ys, xs = np.nonzero(self.state.cell_wall[0].cpu().numpy())
        return np.stack([xs, ys], axis=1).astype(np.int32)

    def _get_render_info(self, x_range, y_range):
        """({id: [x, y, group]} of the agents in the window, last step's
        attack events [n, 3]).  Querying render info activates event
        capture, like the first render() (reference: GridWorld.cc:797-798):
        the first query returns no events, later ones return last step's
        attack events."""
        host = self._frame_host()
        if self._render_ever:
            ev = attack_events(self, host)
            self._attack_events = (
                np.asarray(ev, np.int32).reshape(-1, 3)
                if ev else np.zeros((0, 3), np.int32))
        self._render_ever = True
        agent_info = {}
        for handle in self.group_handles:
            g = handle.value
            off = self.spec.groups[g].offset
            sl = slice(off, off + int(host["n_in_group"][g]))
            xs, ys = host["x"][sl], host["y"][sl]
            keep = ((x_range[0] <= xs) & (xs <= x_range[1])
                    & (y_range[0] <= ys) & (ys <= y_range[1]))
            if self.spec.groups[g].type.can_absorb:
                keep &= host["absorbed"][sl]
            idx = np.nonzero(keep)[0]
            for i, x, y in zip(host["id"][sl][idx].tolist(),
                               xs[idx].tolist(), ys[idx].tolist()):
                agent_info[i] = [x, y, g]
        return agent_info, self._attack_events

    # ----------------------------------------------------------- special
    def set_goal(self, handle, method, *args, **kwargs):
        """Assign per-agent goals (deprecated upstream; reference:
        GridWorld.cc:667-679): two engine-RNG draws per agent, stored
        coordinates, always method="random" (gridworld.py:485-488)."""
        g = handle.value if isinstance(handle, Handle) else int(handle)
        n = self.get_num(Handle(g))
        W, H = self.spec.width, self.spec.height
        goals = np.zeros((n, 2), np.int32)
        for i in range(n):
            goals[i, 0] = self._lcg() % W
            goals[i, 1] = self._lcg() % H
        self._goals[g] = goals
        self.state = self.state.replace(lcg=self._lcg_tensor())
