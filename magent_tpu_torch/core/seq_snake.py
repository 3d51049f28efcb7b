"""Reference-order DiscreteSnake engine for bit-exact golden parity (a copy
of ``magent_tpu/core/seq_snake.py``; host NumPy only, no torch and no
device).

A host-side replica of the reference C++ snake engine
(reference: src/discrete_snake/DiscreteSnake.cc, Map.cc) driven by the
glibc ``random()`` stream (:mod:`magent_tpu_torch.core.glibc_random`) — the
sequential counterpart of :class:`magent_tpu_torch.discrete_snake.
DiscreteSnake` (the vectorized engine), exactly like core/seq_engine.py is
for the gridworld.  Quirks replicated deliberately:

- ``get_random_blank``'s body walk tests the CURRENT cell instead of the
  stepped-to cell (Map.cc:84-99), so the walk always takes the first
  non-reverse direction and only fails via the next iteration's blank test;
- the dead reward is ``-max_dead_penalty`` (DiscreteSnake.cc:238 — a
  double negation: the shipped configs pass a negative penalty, so dying
  ADDS ``|penalty|``);
- self-collision does not kill (move_head increments the shared-cell
  count, Map.cc:196-200); two heads on one cell kill both
  (DiscreteSnake.cc:225-229) and those cells seed the resource rebalance
  in sorted pos2int order (x*H + y, Map.h:60-63);
- agents act and resolve in vector order; ``reset`` frees agents but NOT
  foods (DiscreteSnake.cc:40-51).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from .glibc_random import GlibcRandom

ACT_RIGHT, ACT_DOWN, ACT_LEFT, ACT_UP, ACT_NOOP, ACT_NUM = 0, 1, 2, 3, 4, 5
DIR_NUM = 4
OCC_NONE, OCC_WALL, OCC_FOOD, OCC_AGENT = 0, 1, 2, 3
CHANNEL_NUM = 5  # wall food self other id
_DELTA = [(1, 0), (0, 1), (-1, 0), (0, -1)]
_DIR2INVERSE = [ACT_LEFT, ACT_UP, ACT_RIGHT, ACT_DOWN]


class _Agent:
    __slots__ = ("id", "body", "dir", "last_action", "next_reward",
                 "total_reward", "dead")

    def __init__(self, aid):
        self.id = aid
        self.body = deque()
        self.dir = DIR_NUM
        self.last_action = ACT_NUM
        self.next_reward = 0.0
        self.total_reward = 0.0
        self.dead = False


class SequentialSnake:
    """Same Python API surface as the vectorized DiscreteSnake."""

    def __init__(self, config, **kwargs):
        cd = getattr(config, "config_dict", config)
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
        self.rng = GlibcRandom(int(cd.get("seed", 1)) or 1)
        self.reset()

    # ----------------------------------------------------------------- setup
    def reset(self):
        # the reference bumps the replay file number on every reset
        # (DiscreteSnake.cc:43); same deferred-counter scheme as the
        # vectorized DiscreteSnake (the constructor's internal reset does
        # not count)
        gen = getattr(self, "_render_gen", None)
        if gen is not None:
            gen.file_ct += 1
            gen.frame_ct = 0
        else:
            self._render_reset_ct = getattr(self, "_render_reset_ct", -1) + 1
        W, H = self.width, self.height
        self.id_counter = 0
        self.phantom_foods = 0
        self.occ_type = np.zeros(W * H, np.int8)
        self.occ_id = np.full(W * H, -1, np.int64)
        self.occ_ct = np.zeros(W * H, np.int32)
        for x in range(W):
            self._add_wall(x, 0)
            self._add_wall(x, H - 1)
        for y in range(H):
            self._add_wall(0, y)
            self._add_wall(W - 1, y)
        self.agents: list[_Agent] = []
        # reference reset() frees agents but not foods; golden scenarios
        # reset exactly once so both start empty
        self.foods: dict[int, tuple[int, int, float]] = {}
        self.food_counter = 0

    def _pos2int(self, x, y):
        return x * self.height + y

    def _add_wall(self, x, y):
        p = self._pos2int(x, y)
        if self.occ_type[p] == OCC_NONE:
            self.occ_type[p] = OCC_WALL

    def _get_random_blank(self, n):
        """reference: Map::get_random_blank (Map.cc:65-103), walk quirk
        included."""
        tries = 0
        W, H = self.width, self.height
        while tries < W * H:
            last_dir = 100
            x = self.rng.random() % W
            y = self.rng.random() % H
            pos = []
            complete = True
            for _ in range(n):
                p = self._pos2int(x, y)
                if self.occ_type[p] != OCC_NONE:
                    complete = False
                    break
                pos.append((x, y))
                start = self.rng.random() % 100
                for j in range(4):
                    d = (start + j) % 4
                    if abs(d - last_dir) == 2:
                        continue
                    nx, ny = x, y
                    if d == 0:
                        nx -= 1
                    elif d == 1:
                        ny -= 1
                    elif d == 2:
                        nx += 1
                    else:
                        ny += 1
                    # quirk: tests the CURRENT cell (known blank)
                    if self.occ_type[p] == OCC_NONE:
                        x, y = nx, ny
                        last_dir = d
                        break
            if complete:
                return pos
            tries += 1
        return None

    def _add_food_at(self, x, y, value):
        p = self._pos2int(x, y)
        if self.occ_type[p] != OCC_NONE:
            return False
        fid = self.food_counter
        self.food_counter += 1
        self.occ_type[p] = OCC_FOOD
        self.occ_id[p] = fid
        self.foods[fid] = (x, y, value)
        return True

    def add_food(self, method="random", n=0, **kwargs):
        assert method == "random"
        for _ in range(int(n)):
            pos = self._get_random_blank(1)
            if pos is None:
                # the reference inserts the Food into its set even when no
                # blank was found (add_object/rebalance call foods.insert
                # unconditionally while map.add_food fails on the reused
                # stale position, DiscreteSnake.cc:100-101,276-277) — the
                # phantom counts against total_resource forever
                self.phantom_foods += 1
                continue
            self._add_food_at(pos[0][0], pos[0][1], self.corpse_value)

    def add_agent(self, method="random", n=0, **kwargs):
        assert method == "random"
        for _ in range(int(n)):
            agent = _Agent(self.id_counter)
            self.id_counter += 1
            agent.dir = self.rng.random() % DIR_NUM
            pos = self._get_random_blank(self.initial_length)
            if pos is None:
                continue
            agent.body = deque(pos)
            for (x, y) in pos:
                p = self._pos2int(x, y)
                self.occ_type[p] = OCC_AGENT
                self.occ_id[p] = agent.id
                self.occ_ct[p] = 1
            self.agents.append(agent)

    def add_walls(self, method="random", n=0, **kwargs):
        pass  # the reference's wall branch is empty (DiscreteSnake.cc:93)

    # ------------------------------------------------------------------- api
    def get_num(self, handle=0):
        return len(self.agents)

    def get_food_num(self):
        return len(self.foods)

    def get_agent_id(self, handle=0):
        return np.asarray([a.id for a in self.agents], np.int32)

    def get_alive(self, handle=0):
        return np.asarray([not a.dead for a in self.agents], bool)

    def get_length(self, handle=0):
        return np.asarray([len(a.body) for a in self.agents], np.int32)

    def get_head(self, handle=0):
        return np.asarray(
            [[a.body[0][0], a.body[0][1]] for a in self.agents], np.int32
        ).reshape(-1, 2)

    def get_reward(self, handle=0):
        return np.asarray([a.next_reward for a in self.agents], np.float32)

    # ---------------------------------------------------------------- render
    def wall_mask(self):
        W, H = self.width, self.height
        return (np.asarray(self.occ_type).reshape(W, H).T == OCC_WALL)

    def set_render_dir(self, name):
        from ..render.generator import SnakeRenderGenerator

        self._render_dir = name
        self._render_gen = SnakeRenderGenerator(name)
        self._render_gen.file_ct = getattr(self, "_render_reset_ct", 0)
        self._render_gen.gen_config(self)

    def render(self):
        """Dump one frame in the reference snake format (reference:
        src/discrete_snake/RenderGenerator.cc:146-203; food order follows
        this engine's creation order — the reference iterates a
        std::set<Food*> keyed by heap addresses, which is not reproducible
        even across its own runs).  Does nothing until
        :meth:`set_render_dir` has attached a dumper."""
        gen = getattr(self, "_render_gen", None)
        if gen is None:
            return
        foods = [(x, y) for (x, y, v) in self.foods.values()]
        bodies = [list(a.body)[::-1] for a in self.agents if not a.dead]
        gen.write_frame(foods, bodies)

    def render_next_file(self):
        gen = getattr(self, "_render_gen", None)
        if gen is not None:
            gen.file_ct += 1
            gen.frame_ct = 0

    def get_view_space(self, handle=0):
        return (self.view_height, self.view_width, CHANNEL_NUM)

    def get_feature_space(self, handle=0):
        return self.embedding_size + ACT_NUM + 1

    def get_action_space(self, handle=0):
        return (ACT_NUM,)

    def set_action(self, handle, actions):
        for a, act in zip(self.agents, np.asarray(actions).tolist()):
            a.last_action = int(act)

    def get_observation(self, handle=0):
        """reference: DiscreteSnake::get_observation + Map::extract_view
        (DiscreteSnake.cc:127-153, Map.cc:118-165)."""
        n = len(self.agents)
        vh, vw = self.view_height, self.view_width
        F = self.get_feature_space()
        views = np.zeros((n, vh, vw, CHANNEL_NUM), np.float32)
        feats = np.zeros((n, F), np.float32)
        W, H = self.width, self.height
        for i, agent in enumerate(self.agents):
            hx, hy = agent.body[0]
            x_start = max(0, min(W - 1, hx - vw // 2))
            x_end = max(0, min(W - 1, hx - vw // 2 + vw - 1))
            y_start = max(0, min(H - 1, hy - vh // 2))
            y_end = max(0, min(H - 1, hy - vh // 2 + vh - 1))
            vx0 = x_start - (hx - vw // 2)
            vy0 = y_start - (hy - vh // 2)
            for dx, x in enumerate(range(x_start, x_end + 1)):
                for dy, y in enumerate(range(y_start, y_end + 1)):
                    p = self._pos2int(x, y)
                    t = self.occ_type[p]
                    if t == OCC_WALL:
                        views[i, vy0 + dy, vx0 + dx, 0] = 1
                    elif t == OCC_FOOD:
                        views[i, vy0 + dy, vx0 + dx, 1] = 1
                    elif t == OCC_AGENT:
                        if self.occ_id[p] == agent.id:
                            views[i, vy0 + dy, vx0 + dx, 2] = 1
                        else:
                            views[i, vy0 + dy, vx0 + dx, 3] = 1
                        views[i, vy0 + dy, vx0 + dx, 4] = (
                            float(self.occ_id[p] + 1) / max(self.id_counter, 1))
            t = agent.id
            for k in range(self.embedding_size):
                feats[i, k] = float(t & 1)
                t >>= 1
            feats[i, self.embedding_size + min(agent.last_action, ACT_NUM)] = 1
            feats[i, self.embedding_size + ACT_NUM] = len(agent.body)
        return views, feats

    # ------------------------------------------------------------------ step
    def step(self):
        """reference: DiscreteSnake::step (DiscreteSnake.cc:164-305)."""
        eps = 1e-6
        agents = self.agents

        # phase 1: update bodies (push head, maybe pop tail)
        for agent in agents:
            act = agent.last_action
            d = agent.dir
            if (act != ACT_NOOP and act != ACT_NUM and act != d
                    and (d >= DIR_NUM or act != _DIR2INVERSE[d])):
                d = act
                agent.dir = d
            hx, hy = agent.body[0]
            hx += _DELTA[d][0]
            hy += _DELTA[d][1]
            agent.body.appendleft((hx, hy))
            if agent.total_reward + 1 + self.initial_length - eps < len(agent.body):
                tx, ty = agent.body.pop()
                p = self._pos2int(tx, ty)
                self.occ_ct[p] -= 1
                if self.occ_ct[p] == 0:
                    self.occ_type[p] = OCC_NONE

        head_mask = {}
        for agent in agents:
            p = self._pos2int(*agent.body[0])
            head_mask[p] = head_mask.get(p, 0) + 1

        # phase 2: resolve heads in vector order
        eat_list = []
        dead_list = []
        double_heads = set()
        added_length = 0
        for agent in agents:
            hx, hy = agent.body[0]
            p = self._pos2int(hx, hy)
            dead = False
            eaten = None
            reward = 0.0
            if head_mask[p] > 1:
                dead = True
                double_heads.add(p)
            else:
                t = self.occ_type[p]
                if t == OCC_NONE:
                    self.occ_type[p] = OCC_AGENT
                    self.occ_id[p] = agent.id
                    self.occ_ct[p] = 1
                elif t == OCC_AGENT:
                    if self.occ_id[p] != agent.id:
                        dead = True
                    else:
                        self.occ_ct[p] += 1
                elif t == OCC_WALL:
                    dead = True
                else:  # OCC_FOOD
                    fid = int(self.occ_id[p])
                    eaten = fid
                    reward = self.foods[fid][2]
                    self.occ_type[p] = OCC_AGENT
                    self.occ_id[p] = agent.id
                    self.occ_ct[p] = 1
            if dead:
                dead_list.append(agent)
                agent.dead = True
                agent.next_reward += -self.max_dead_penalty
                agent.total_reward += -self.max_dead_penalty
            else:
                if eaten is not None:
                    eat_list.append(eaten)
                    agent.next_reward += reward
                    agent.total_reward += reward
                added_length += len(agent.body) - self.initial_length

        for fid in eat_list:
            self.foods.pop(fid, None)

        # phase 3: dead bodies become food (skip the head,
        # Map::make_food Map.cc:221-244)
        for agent in dead_list:
            add = len(agent.body) - self.initial_length
            ct = 0
            first = True
            for (x, y) in agent.body:
                if first:
                    first = False
                    continue
                p = self._pos2int(x, y)
                if self.occ_type[p] == OCC_AGENT:
                    if ct < add:
                        fid = self.food_counter
                        self.food_counter += 1
                        self.occ_type[p] = OCC_FOOD
                        self.occ_id[p] = fid
                        self.foods[fid] = (x, y, self.corpse_value)
                        ct += 1
                    else:
                        self.occ_type[p] = OCC_NONE

        # phase 4: resource balancing (phantoms: see add_food)
        add = (self.total_resource - added_length
               - len(self.foods) - self.phantom_foods)
        if add > 0:
            for p in sorted(double_heads):
                x, y = p // self.height, p % self.height
                if self._add_food_at(x, y, self.corpse_value):
                    add -= 1
                    if add == 0:
                        break
        if add > 0:
            self.add_food("random", add)
        return False

    def clear_dead(self):
        kept = []
        for agent in self.agents:
            if not agent.dead:
                agent.next_reward = 0.0
                kept.append(agent)
        self.agents = kept
