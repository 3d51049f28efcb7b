"""DiscreteSnake: the reference's second (deprecated) game, in PyTorch (port
of ``magent_tpu/discrete_snake.py``).

Capability parity with the reference engine (reference:
src/discrete_snake/DiscreteSnake.{h,cc}, Map.{h,cc}, snake_def.h and the
Python wrapper python/magent/discrete_snake.py):

- snakes move on a grid with actions RIGHT/DOWN/LEFT/UP/NOOP; reversing is
  ignored (DiscreteSnake.cc:184-193);
- bodies grow with accumulated reward (tail pops while
  ``total_reward + 1 + initial_length - eps >= length``,
  DiscreteSnake.cc:199-201);
- heads hitting walls or other snakes die; two heads on one cell kill both;
  eating food adds its value as reward (Map::move_head, Map.cc:183-218);
- dead snakes turn into corpse food and the total food resource is
  rebalanced every step (DiscreteSnake.cc:246-281);
- observations are a (view_h, view_w, 5) window around the head with
  channels wall/food/self/other/id plus features
  [id embedding | last-action one-hot | length] (snake_def.h:29,
  DiscreteSnake.cc:127-152).

Bodies are fixed-capacity ring buffers ``[A, max_length]``; grids (owner
slot, per-cell body count, food value, wall) are dense tensors on
``device`` (the GPU unless the caller names the CPU); one step of plain
tensor code resolves every snake at once, and the observation slices each
head's window out of a 5-channel image with the port's ``window_gather``
kernel.  Placement (``add_walls``, ``add_food``, ``add_agent``) runs on the
host with ``np.random.RandomState``, as in the JAX package; the food spawn
draws from the threefry key ``PRNGKey(7)`` through :mod:`..random`, so a
trajectory equals the JAX package's bit for bit.

``engine_mode="sequential"`` returns the reference-order host engine
(:class:`core.seq_snake.SequentialSnake`): host NumPy only, it takes no
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import random as rnd
from .core.seq_snake import SequentialSnake
from .ops import window_gather as wg
from .parallel.vec_env import resolve_device
from .render.generator import SnakeRenderGenerator

ACT_RIGHT, ACT_DOWN, ACT_LEFT, ACT_UP, ACT_NOOP, ACT_NUM = 0, 1, 2, 3, 4, 5
_DELTA = np.asarray([[1, 0], [0, 1], [-1, 0], [0, -1]], np.int32)
_INVERSE = np.asarray([ACT_LEFT, ACT_UP, ACT_RIGHT, ACT_DOWN], np.int32)
CHANNEL_NUM = 5  # wall food self other id
# food-spawn candidates drawn per step (discrete_snake.py:378-382)
_SPAWN = 1024


class Config:
    """reference: python/magent/discrete_snake.py:204-209"""

    def __init__(self):
        self.config_dict = {}

    def set(self, args):
        for key in args:
            self.config_dict[key] = args[key]


@dataclasses.dataclass
class SnakeState:
    body_x: torch.Tensor  # int32 [A, L] ring buffer
    body_y: torch.Tensor  # int32 [A, L]
    head: torch.Tensor  # int32 [A], ring index of the head
    length: torch.Tensor  # int32 [A]
    dir: torch.Tensor  # int32 [A]
    alive: torch.Tensor  # bool [A]
    active: torch.Tensor  # bool [A] (slot in use; dead-but-not-cleared stays)
    id: torch.Tensor  # int32 [A]
    last_action: torch.Tensor  # int32 [A]
    total_reward: torch.Tensor  # float32 [A] (drives growth)
    step_reward: torch.Tensor  # float32 [A]
    cell_owner: torch.Tensor  # int32 [H, W] slot or -1
    cell_ct: torch.Tensor  # int32 [H, W] body segments on the cell
    cell_food: torch.Tensor  # float32 [H, W]
    cell_wall: torch.Tensor  # bool [H, W]
    key: torch.Tensor  # int64 [2], uint32 threefry key words
    id_counter: torch.Tensor  # int32 []

    def replace(self, **changes) -> "SnakeState":
        return dataclasses.replace(self, **changes)


SNAKE_FIELDS = tuple(f.name for f in dataclasses.fields(SnakeState))


def _cells(grid, y, x, ok):
    """Flat indices into ``grid`` [H, W] padded by one dummy cell: ``y * W
    + x`` where ``ok``, else the dummy ``H * W`` (JAX's ``mode="drop"`` of
    an out-of-range index)."""
    H, W = grid.shape
    return torch.where(ok, y.long() * W + x.long(), H * W).reshape(-1)


def _padded(grid):
    return torch.cat([grid.reshape(-1), grid.new_zeros(1)])


def _scatter_add(grid, y, x, ok, value):
    """``grid.at[y, x].add(value)`` where ``ok`` (int grids: the adds
    commute, so the result does not depend on their order)."""
    H, W = grid.shape
    flat = _padded(grid)
    idx = _cells(grid, y, x, ok)
    flat.index_add_(0, idx, torch.full_like(idx, value, dtype=grid.dtype))
    return flat[:H * W].reshape(H, W)


def _scatter_set(grid, y, x, ok, values):
    """``grid.at[y, x].set(values)`` where ``ok``.  The callers' cells are
    either unique (survivors' heads: double heads die) or all given one
    value (the corpse value, -1, 0), so the unspecified order of a CUDA
    ``index_put_`` among duplicates cannot change the result; only the
    dummy cell takes writes of differing values, and it is cut away."""
    H, W = grid.shape
    flat = _padded(grid)
    idx = _cells(grid, y, x, ok)
    if not isinstance(values, torch.Tensor):  # made on the device: no copy
        values = torch.full((), values, dtype=grid.dtype, device=grid.device)
    flat[idx] = values.expand(ok.shape).reshape(-1)
    return flat[:H * W].reshape(H, W)


class DiscreteSnake:
    OBS_VIEW_INDEX = 0
    OBS_FEATURE_INDEX = 1

    def __new__(cls, config=None, *args, engine_mode: str = "fast", **kwargs):
        if engine_mode == "sequential":
            # reference-order host engine driven by the glibc random()
            # stream: the bit-exact parity mode (core/seq_snake.py)
            return SequentialSnake(config, **kwargs)
        return super().__new__(cls)

    def __init__(self, config, caps: int = 256, max_length: int = 48,
                 engine_mode: str = "fast", device=None, **kwargs):
        cd = config.config_dict
        self.device = resolve_device(device)
        self.width = int(cd.get("map_width", 100))
        self.height = int(cd.get("map_height", 100))
        self.view_width = int(cd.get("view_width", 21))
        self.view_height = int(cd.get("view_height", 21))
        self.max_dead_penalty = float(cd.get("max_dead_penalty", -10))
        self.corpse_value = float(cd.get("corpse_value", 1))
        self.initial_length = int(cd.get("initial_length", 3))
        # the reference hardcodes (int)(100*100*0.1) in its constructor and
        # never recomputes it from the actual map size
        # (DiscreteSnake.cc:20,75-76)
        self.total_resource = int(cd.get("total_resource", 1000))
        self.embedding_size = int(cd.get("embedding_size", 16))
        self.caps = caps
        self.max_length = max_length

        self.view_space = [self.view_height, self.view_width, CHANNEL_NUM]
        self.feature_space = self.embedding_size + ACT_NUM + 1
        self.action_space = ACT_NUM

        self._rng = np.random.RandomState(int(cd.get("seed", 0)))
        self._actions = np.zeros(caps, np.int32)
        self._step_fn = self._make_step()
        self._obs_fn = self._make_observe()
        self.reset()

    # ------------------------------------------------------------- state
    def reset(self):
        # the reference bumps the replay file number on EVERY reset
        # (DiscreteSnake.cc:43 render_generator.next_file()); without a
        # render generator the count waits here (the constructor's internal
        # reset does not count: the reference constructor never resets)
        gen = getattr(self, "_render_gen", None)
        if gen is not None:
            gen.file_ct += 1
            gen.frame_ct = 0
        else:
            self._render_reset_ct = getattr(self, "_render_reset_ct", -1) + 1
        H, W, A, L = self.height, self.width, self.caps, self.max_length
        dev = self.device

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        wall = full((H, W), False, torch.bool)
        wall[0, :] = wall[-1, :] = True
        wall[:, 0] = wall[:, -1] = True
        self.state = SnakeState(
            body_x=full((A, L), 0, torch.int32),
            body_y=full((A, L), 0, torch.int32),
            head=full((A,), 0, torch.int32),
            length=full((A,), 0, torch.int32),
            dir=full((A,), 0, torch.int32),
            alive=full((A,), False, torch.bool),
            active=full((A,), False, torch.bool),
            id=full((A,), 0, torch.int32),
            last_action=full((A,), ACT_NUM, torch.int32),
            total_reward=full((A,), 0.0, torch.float32),
            step_reward=full((A,), 0.0, torch.float32),
            cell_owner=full((H, W), -1, torch.int32),
            cell_ct=full((H, W), 0, torch.int32),
            cell_food=full((H, W), 0.0, torch.float32),
            cell_wall=wall,
            key=rnd.PRNGKey(7, dev),
            id_counter=full((), 0, torch.int32),
        )
        self._actions[:] = ACT_NOOP

    def _host(self, name):
        return getattr(self.state, name).cpu().numpy()

    def _tensor(self, array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    # -------------------------------------------------------- add object
    def _blank_host(self):
        return (~self._host("cell_wall")) & (self._host("cell_owner") < 0) \
            & (self._host("cell_food") <= 0)

    def add_walls(self, method, **kwargs):
        assert method == "random"
        blank = self._blank_host()
        wall = self._host("cell_wall").copy()
        ys, xs = np.nonzero(blank)
        pick = self._rng.choice(len(xs), size=min(int(kwargs["n"]), len(xs)),
                                replace=False)
        wall[ys[pick], xs[pick]] = True
        self.state = self.state.replace(cell_wall=self._tensor(wall))

    def add_food(self, method, **kwargs):
        assert method == "random"
        blank = self._blank_host()
        food = self._host("cell_food").copy()
        ys, xs = np.nonzero(blank)
        pick = self._rng.choice(len(xs), size=min(int(kwargs["n"]), len(xs)),
                                replace=False)
        food[ys[pick], xs[pick]] = self.corpse_value
        self.state = self.state.replace(cell_food=self._tensor(food))

    def add_agent(self, method, *args, **kwargs):
        """random snake placement by a short self-avoiding walk
        (reference: Map::get_random_blank, discrete_snake/Map.cc:65-111)"""
        assert method == "random"
        n = int(kwargs["n"])
        blank = self._blank_host()
        names = ("cell_owner", "cell_ct", "body_x", "body_y", "head",
                 "length", "dir", "alive", "active", "id")
        h = {k: self._host(k).copy() for k in names}
        idc = int(self.state.id_counter)

        free_slots = np.nonzero(~h["active"])[0]
        placed = 0
        tries = 0
        while placed < n and placed < len(free_slots) and \
                tries < self.width * self.height:
            tries += 1
            body = []
            x = self._rng.randint(self.width)
            y = self._rng.randint(self.height)
            ok = True
            last_dir = 100
            for i in range(self.initial_length):
                if not blank[y, x]:
                    ok = False
                    break
                body.append((x, y))
                start = self._rng.randint(100)
                moved = False
                for j in range(4):
                    d = (start + j) % 4
                    if abs(d - last_dir) == 2:
                        continue
                    nx, ny = x + _DELTA[d][0], y + _DELTA[d][1]
                    if 0 <= nx < self.width and 0 <= ny < self.height \
                            and blank[ny, nx] and (nx, ny) not in body:
                        x, y, last_dir, moved = nx, ny, d, True
                        break
                if not moved and i < self.initial_length - 1:
                    ok = False
                    break
            if not ok or len(body) < self.initial_length:
                continue
            slot = free_slots[placed]
            # body[0] is the head in ring order
            for i, (cx, cy) in enumerate(body):
                ring = (self.initial_length - 1 - i) % self.max_length
                h["body_x"][slot, ring] = cx
                h["body_y"][slot, ring] = cy
                h["cell_owner"][cy, cx] = slot
                h["cell_ct"][cy, cx] += 1
                blank[cy, cx] = False
            h["head"][slot] = self.initial_length - 1
            h["length"][slot] = self.initial_length
            h["dir"][slot] = self._rng.randint(4)
            h["alive"][slot] = True
            h["active"][slot] = True
            h["id"][slot] = idc
            idc += 1
            placed += 1

        self.state = self.state.replace(
            **{k: self._tensor(v) for k, v in h.items()},
            id_counter=torch.tensor(idc, dtype=torch.int32,
                                    device=self.device))

    # -------------------------------------------------------------- step
    def _make_step(self):
        H, W, A, L = self.height, self.width, self.caps, self.max_length
        dev = self.device
        init_len = self.initial_length
        eps = 1e-6
        delta = torch.as_tensor(_DELTA, device=dev)
        inverse = torch.as_tensor(_INVERSE, device=dev)
        rows = torch.arange(A, device=dev)
        rows32 = rows.to(torch.int32)
        back = torch.arange(L, device=dev)  # i: the i-th segment from the head
        order = torch.arange(_SPAWN, dtype=torch.int32, device=dev)
        corpse_value = self.corpse_value
        max_dead_penalty = self.max_dead_penalty
        total_resource = self.total_resource

        def gather_body(bx, by, ring_idx):
            take = ring_idx.clamp(0, L - 1).long()
            return bx[rows, take], by[rows, take]

        def step(st: SnakeState, act):
            alive = st.alive & st.active

            # direction update (DiscreteSnake.cc:184-193)
            change = alive & (act != ACT_NOOP) & (act != st.dir) & (
                act != inverse[st.dir.clamp(0, 3).long()])
            d = torch.where(change, act, st.dir)

            # push the new head into the ring
            hx, hy = gather_body(st.body_x, st.body_y, st.head)
            dd = d.clamp(0, 3).long()
            nhx = (hx + delta[dd, 0]).clamp(0, W - 1)
            nhy = (hy + delta[dd, 1]).clamp(0, H - 1)
            new_head_idx = torch.where(alive, (st.head + 1) % L, st.head)
            nhi = new_head_idx.long()
            body_x, body_y = st.body_x.clone(), st.body_y.clone()
            body_x[rows, nhi] = torch.where(alive, nhx, st.body_x[rows, nhi])
            body_y[rows, nhi] = torch.where(alive, nhy, st.body_y[rows, nhi])
            # a full ring (length == L) overwrites its own tail slot: a
            # FORCED tail pop (the reference's deque is unbounded; here the
            # lost tail cell must leave the grid or it haunts it forever)
            forced = alive & (st.length >= L)
            length = torch.where(alive, (st.length + 1).clamp(max=L),
                                 st.length)

            # pop the tail while too long (DiscreteSnake.cc:199-201).  The
            # post-push tail is element length-1, ring new_head-(length-1);
            # a forced pop removes the old tail whose ring slot the push
            # just overwrote (= new_head_idx), so its coordinates come from
            # the pre-push ring, equal to the post-push ring at the normal
            # tail slot for length >= 2
            want = torch.floor(st.total_reward + 1 + init_len - eps).to(
                torch.int32)
            pop = alive & (want < length)
            tail_idx = torch.where(forced, new_head_idx,
                                   (new_head_idx - (length - 1) + L) % L)
            tx, ty = gather_body(st.body_x, st.body_y, tail_idx)
            cell_ct = _scatter_add(st.cell_ct, ty, tx, pop | forced, -1)
            length = torch.where(pop, length - 1, length)

            # head collision resolution (DiscreteSnake.cc:205-244)
            head_cell = nhy.long() * W + nhx.long()
            head_cnt = torch.zeros(H * W + 1, dtype=torch.int32, device=dev)
            head_cnt.index_add_(0, torch.where(alive, head_cell, H * W),
                                torch.ones(A, dtype=torch.int32, device=dev))
            double_head = alive & (head_cnt[head_cell] > 1)
            ny_, nx_ = nhy.long(), nhx.long()
            hit_wall = alive & st.cell_wall[ny_, nx_]
            owner_at = st.cell_owner[ny_, nx_]
            # cells vacated by tail pops this step do NOT count as occupied
            # (the reference pops every tail before any head check,
            # DiscreteSnake.cc:183-206): hence the post-pop cell_ct here
            occupied = (owner_at >= 0) & (cell_ct[ny_, nx_] > 0)
            hit_other = alive & occupied & (owner_at != rows32)
            food_val = st.cell_food[ny_, nx_]
            eat = alive & ~double_head & ~hit_wall & ~hit_other & (
                food_val > 0)
            dead_now = double_head | hit_wall | hit_other

            step_reward = torch.where(eat, food_val, 0.0)
            step_reward = torch.where(dead_now, -max_dead_penalty,
                                      step_reward)
            total_reward = st.total_reward + torch.where(alive, step_reward,
                                                         0.0)

            # eaten food disappears; survivors' heads occupy their cells
            cell_food = _scatter_set(st.cell_food, nhy, nhx, eat, 0.0)
            surv = alive & ~dead_now
            cell_owner = _scatter_set(st.cell_owner, nhy, nhx, surv, rows32)
            cell_ct = _scatter_add(cell_ct, nhy, nhx, surv, 1)

            # dead snakes: remove the body and drop corpse food on its cells
            # beyond the initial length (DiscreteSnake.cc:252-259), every
            # segment i of every snake at once ([A, L]); i = 0 is the
            # just-pushed head, which a dead snake never put on the grid
            corpse_budget = torch.where(dead_now, length - init_len, 0)
            ring = (new_head_idx[:, None] - back[None, :] + L) % L
            in_body = dead_now[:, None] & (back[None, :] >= 1) & (
                back[None, :] < length[:, None])
            cx = body_x.gather(1, ring.long())
            cy = body_y.gather(1, ring.long())
            cell_ct = _scatter_add(cell_ct, cy, cx, in_body, -1)
            cell_owner = _scatter_set(cell_owner, cy, cx, in_body, -1)
            drop = in_body & (back[None, :] <= corpse_budget[:, None])
            cell_food = _scatter_set(cell_food, cy, cx, drop, corpse_value)

            # owner invariant: cells whose body count hit zero are free
            cell_owner = torch.where(cell_ct > 0, cell_owner, -1)

            alive_next = alive & ~dead_now

            # resource balancing (DiscreteSnake.cc:262-281): spawn food on
            # random blank cells until total food ~= total_resource
            added_length = torch.where(alive_next, length - init_len, 0).sum()
            n_food = (cell_food > 0).sum()
            need = (total_resource - added_length - n_food).clamp(0, _SPAWN)
            keys = rnd.split(st.key)
            key, sub = keys[0], keys[1]
            k12 = rnd.split(sub)
            fx = rnd.randint(k12[0], (_SPAWN,), 0, W).long()
            fy = rnd.randint(k12[1], (_SPAWN,), 0, H).long()
            blank = (~st.cell_wall[fy, fx]) & (cell_ct[fy, fx] == 0) & (
                cell_food[fy, fx] <= 0)
            # count each cell once: two candidates on the same blank cell
            # spawn ONE food but would decrement `need` twice otherwise; the
            # first candidate of a cell is a scatter-min (deterministic)
            cells = fy * W + fx
            first = torch.full((H * W + 1,), 1 << 30, dtype=torch.int32,
                               device=dev).scatter_reduce_(
                0, torch.where(blank, cells, H * W), order, "amin",
                include_self=True)
            uniq = blank & (first[cells] == order)
            take = uniq & (uniq.to(torch.int32).cumsum(0) <= need)
            cell_food = _scatter_set(cell_food, fy, fx, take, corpse_value)

            return st.replace(
                body_x=body_x, body_y=body_y, head=new_head_idx,
                length=length, dir=d, alive=alive_next, last_action=act,
                total_reward=total_reward, step_reward=step_reward,
                cell_owner=cell_owner, cell_ct=cell_ct, cell_food=cell_food,
                key=key)

        return step

    # --------------------------------------------------------------- obs
    def _make_observe(self):
        H, W, A, L = self.height, self.width, self.caps, self.max_length
        vh, vw = self.view_height, self.view_width
        C = CHANNEL_NUM
        emb = self.embedding_size
        dev = self.device
        # the port's geometry returns lanes == Wp * C, as the JAX package's
        # does: its pad to `lanes` (discrete_snake.py:435-436) adds nothing
        Hp, Wp, lanes, pad_y, pad_x = wg.padded_geometry(H, W, C, vh, vw)
        assert lanes == Wp * C
        mask = torch.ones((vh, vw * C), dtype=torch.float32, device=dev)
        rows = torch.arange(A, device=dev)
        bit = torch.arange(emb, device=dev)
        actions = torch.arange(ACT_NUM, device=dev)

        def observe(st: SnakeState):
            # channel image: wall/food (self/other resolved per observer)
            idc = st.id_counter.clamp(min=1).to(torch.float32)
            occupied = st.cell_ct > 0
            owner_id = torch.where(
                occupied,
                (st.id[st.cell_owner.clamp(0, A - 1).long()].to(
                    torch.float32) + 1) / idc,
                0.0)
            img = torch.zeros((Hp, Wp, C), dtype=torch.float32, device=dev)
            inner = img[pad_y:pad_y + H, pad_x:pad_x + W]
            inner[..., 0] = st.cell_wall.to(torch.float32)
            inner[..., 1] = (st.cell_food > 0).to(torch.float32)
            inner[..., 3] = occupied.to(torch.float32)
            inner[..., 4] = owner_id
            flat = img.reshape(1, Hp, lanes)

            take = st.head.clamp(0, L - 1).long()
            hx, hy = st.body_x[rows, take], st.body_y[rows, take]
            pos = ((hy - vh // 2 + pad_y) * Wp + (hx - vw // 2 + pad_x))[None]
            view = wg.window_gather(flat, pos, mask, vh=vh, vw=vw, C=C,
                                    Wp=Wp).reshape(A, vh, vw, C)
            # self channel: cells owned by the observer (detected by id
            # match); other -> 0 there
            owner_win = view[..., 3]
            my_idval = (st.id.to(torch.float32) + 1) / idc
            is_self = ((view[..., 4] - my_idval[:, None, None]).abs()
                       < 1e-6) & (owner_win > 0)
            view = torch.stack([
                view[..., 0], view[..., 1], is_self.to(torch.float32),
                torch.where(is_self, 0.0, owner_win), view[..., 4]], dim=-1)

            feats = []
            if emb > 0:
                feats.append(((st.id[:, None] >> bit[None, :]) & 1).to(
                    torch.float32))
            # jax.nn.one_hot: the fresh snakes' ACT_NUM encodes to zeros
            feats.append((st.last_action[:, None] == actions[None, :]).to(
                torch.float32))
            feats.append(st.length.to(torch.float32)[:, None])
            feature = torch.cat(feats, dim=1)

            view = view * st.active[:, None, None, None]
            feature = feature * st.active[:, None]
            return view, feature

        return observe

    # --------------------------------------------------------------- api
    def get_observation(self, handle=0):
        view, feat = self._obs_fn(self.state)
        active = self.state.active
        return view[active].cpu().numpy(), feat[active].cpu().numpy()

    def set_action(self, handle, actions):
        idx = np.nonzero(self._host("active"))[0]
        acts = np.full(self.caps, ACT_NOOP, np.int32)
        acts[idx] = np.asarray(actions, np.int32)[:len(idx)]
        self._actions = acts

    def step(self):
        self.state = self._step_fn(self.state, self._tensor(self._actions))
        return False

    def _active_host(self, name):
        st = self.state
        return getattr(st, name)[st.active].cpu().numpy()

    def get_reward(self, handle=0):
        return self._active_host("step_reward").astype(np.float32)

    def clear_dead(self):
        st = self.state
        self.state = st.replace(active=st.active & st.alive)

    def get_num(self, handle=0):
        return int(self.state.active.sum())

    def get_action_space(self, handle=0):
        return (self.action_space,)

    def get_view_space(self, handle=0):
        return tuple(self.view_space)

    def get_feature_space(self, handle=0):
        return (self.feature_space,)

    def get_agent_id(self, handle=0):
        return self._active_host("id").astype(np.int32)

    def get_head(self, handle=0):
        idx = np.nonzero(self._host("active"))[0]
        h = self._host("head")[idx] % self.max_length
        return np.stack([self._host("body_x")[idx, h],
                         self._host("body_y")[idx, h]], axis=1).astype(
            np.int32)

    def get_alive(self, handle=0):
        return self._active_host("alive")

    def get_length(self, handle=0):
        return self._active_host("length").astype(np.int32)

    def get_food_num(self):
        return int((self.state.cell_food > 0).sum())

    # ------------------------------------------------------------ render
    def set_render_dir(self, name):
        """Attach a replay dumper writing into ``name`` (``config.json`` and
        ``static.map`` now, ``video_<k>.txt`` per :meth:`render`)."""
        self._render_dir = name
        self._render_gen = SnakeRenderGenerator(name)
        self._render_gen.file_ct = getattr(self, "_render_reset_ct", 0)
        self._render_gen.gen_config(self)

    def render(self):
        """Append one replay frame (reference:
        src/discrete_snake/RenderGenerator.cc:146-203).  Does nothing until
        :meth:`set_render_dir` has attached a dumper."""
        gen = getattr(self, "_render_gen", None)
        if gen is not None:
            gen.render_a_frame(self)

    def render_next_file(self):
        gen = getattr(self, "_render_gen", None)
        if gen is not None:
            gen.file_ct += 1
            gen.frame_ct = 0
