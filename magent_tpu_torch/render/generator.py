"""Replay frame dumper, byte-compatible with the reference render format
(port of ``magent_tpu/render/generator.py``).

Writes ``config.json`` and ``video_<k>.txt`` files exactly like the
reference's RenderGenerator (reference: src/gridworld/RenderGenerator.cc:
gen_config :57-105, render_a_frame :108-185):

- ``config.json``: map size, per-group style/size/speed/view/attack;
- ``video_<k>.txt``: one ``W n`` wall list when a file starts, then per
  frame ``F n_agents n_attacks 0`` followed by agent lines
  ``id hp dir x y group`` and attack-event lines ``op id x y``.

Attack events are reconstructed on the host from the last actions: an
agent whose action is an attack emits ``(id, target_x, target_y)`` whether
or not it hit (reference: GridWorld.cc:475-490 records the event before
checking the target).

The state lives on the device.  A frame reads the fields it needs in one
copy to the host (:func:`to_host`: stacked on the device as int32, hp
bit-cast so that it stays exact); every line is then formatted from NumPy
with the JAX generator's expressions, in its order.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import spec as speclib
from ..core import geometry as geo

# the groups' colors (config.json, and the live client's group info)
COLORS = [(192, 64, 64), (64, 64, 192), (64, 192, 64), (64, 64, 64)]
_DIR2ANGLE = np.asarray([0, 90, 180, 270])
# the per-slot state fields a GridWorld frame reads
FRAME_FIELDS = ("active", "absorbed", "hp", "id", "x", "y", "dir", "dead",
                "last_op")


def _rgba(r, g, b, alpha):
    # match the reference's C++ float printing (0.8 -> "0.8", 1.0 -> "1")
    a = ("%g" % alpha)
    return '"rgba(%d,%d,%d,%s)"' % (r, g, b, a)


def to_host(tensors):
    """Tensors of one device (bool, int32 or float32) as NumPy arrays of
    their shapes and dtypes, in one copy to the host: each is flattened to
    int32 (float32 bit-cast, so exact) and all are concatenated on the
    device first."""
    flat = []
    for t in tensors:
        if t.dtype not in (torch.bool, torch.int32, torch.float32):
            raise TypeError("to_host takes bool, int32 or float32, not %s"
                            % t.dtype)
        t = t.reshape(-1)
        flat.append(t.view(torch.int32) if t.dtype == torch.float32
                    else t.to(torch.int32))
    host = torch.cat(flat).cpu().numpy()
    out, pos = [], 0
    for t in tensors:
        a = host[pos:pos + t.numel()].reshape(tuple(t.shape))
        pos += t.numel()
        if t.dtype == torch.bool:
            a = a != 0
        elif t.dtype == torch.float32:
            a = a.view(np.float32)
        out.append(a)
    return out


def attack_events(env, host=None):
    """Reconstruct (id, tx, ty) per attacking agent from last actions
    (reference: GridWorld.cc:475-490 records the event before checking the
    target).  ``host``: the env's ``_frame_host()`` fields, read here when
    not given.  In sequential mode, once a step has run, the engine's exact
    event list instead."""
    if env._last_attack_events is not None:
        # sequential engine mode: the exact buffer-order event list
        return list(env._last_attack_events)
    if host is None:
        host = env._frame_host()
    x, y, d, ids = host["x"], host["y"], host["dir"], host["id"]
    active, dead, pre_dead = host["active"], host["dead"], host["pre_dead"]
    last_op = host["last_op"]
    events = []
    for g in env.spec.groups:
        t = g.type
        sl = slice(g.offset, g.offset + g.cap)
        act = env._actions[sl]
        # the reference emits the event for every attacker alive AT ITS TURN
        # in the (shuffled) attack phase, even one killed later that step
        # (GridWorld.cc:476-486).  Pre-step liveness excludes agents that
        # died in EARLIER steps (whose sticky ops would otherwise emit
        # phantoms in raw step() chains); for an attacker that died THIS
        # step, its op showing it acted is the best post-step signal (only
        # a mid-phase-killed blank-attacker is unknowable).
        acted = (last_op[sl] == speclib.OP_ATTACK) | (
            last_op[sl] == speclib.OP_KILL)
        is_attack = (
            active[sl] & ~pre_dead[sl] & (~dead[sl] | acted)
            & (act >= t.attack_base) & (act < t.n_action)
        )
        k = np.nonzero(is_attack)[0]
        if not len(k):
            continue
        s = g.offset + k
        delta = np.asarray([t.attack_range.num2delta(i)
                            for i in range(t.attack_range.count)])
        att = act[k] - t.attack_base
        rx, ry = geo.save_to_real_np(x[s], y[s], d[s], t.width, t.length)
        tx, ty = geo.rela_to_abs_np(rx, ry, d[s], t.att_x_offset
                                    + delta[att, 0],
                                    t.att_y_offset + delta[att, 1])
        events.extend(zip(ids[s].tolist(), tx.tolist(), ty.tolist()))
    return events


def _write(path, first, lines):
    with open(path, "w" if first else "a") as f:
        f.write("\n".join(lines) + "\n")


def _config_lines(width, height, groups):
    """config.json's lines; ``groups``: one (height, width, color, alpha,
    max-speed, vision radius, vision angle, attack radius, attack angle)
    per group, the numbers already formatted."""
    lines = ["{"]

    def kv(key, value, last=False):
        lines.append('"%s": %s%s' % (key, value, "" if last else ","))

    kv("width", width)
    kv("height", height)
    kv("static-file", '"static.map"')
    kv("obstacle-style", _rgba(127, 127, 127, 1))
    kv("dynamic-file-directory", '"."')
    kv("attack-style", _rgba(63, 63, 63, 0.8))
    kv("minimap-width", 300)
    kv("minimap-height", 250)
    lines.append('"group" : [')
    for i, (h, w, c, alpha, speed, vr, va, ar, aa) in enumerate(groups):
        lines.append("{")
        kv("height", h)
        kv("width", w)
        kv("style", _rgba(c[0], c[1], c[2], alpha))
        kv("anchor", "[0, 0]")
        kv("max-speed", speed)
        kv("speed-style", _rgba(c[0], c[1], c[2], 0.01))
        kv("vision-radius", vr)
        kv("vision-angle", va)
        kv("vision-style", _rgba(c[0], c[1], c[2], 0.2))
        kv("attack-radius", ar)
        kv("attack-angle", aa)
        kv("attack-style", _rgba(c[0], c[1], c[2], 0.1))
        kv("broadcast-radius", 1, last=True)
        lines.append("}," if i < len(groups) - 1 else "}")
    lines.append("]")
    lines.append("}")
    return lines


class RenderGenerator:
    def __init__(self, save_dir: str, frame_per_file: int = 10000):
        self.save_dir = save_dir
        self.frame_per_file = frame_per_file
        self.file_ct = 0
        self.frame_ct = 0
        os.makedirs(save_dir, exist_ok=True)

    def next_file(self):
        self.file_ct += 1
        self.frame_ct = 0

    # ----------------------------------------------------------------- config
    def gen_config(self, env):
        """reference: RenderGenerator::gen_config (RenderGenerator.cc:57-105)"""
        spec = env.spec
        groups = []
        for i, g in enumerate(spec.groups):
            t = g.type
            groups.append((t.length, t.width, COLORS[i % len(COLORS)], 1,
                           int(t.speed), "%g" % t.view_radius,
                           "%g" % t.view_angle, "%g" % t.attack_radius,
                           "%g" % t.attack_angle))
        _write(os.path.join(self.save_dir, "config.json"), True,
               _config_lines(spec.width, spec.height, groups))

    # ----------------------------------------------------------------- frames
    def render_a_frame(self, env, include_events=True):
        """reference: RenderGenerator::render_a_frame
        (RenderGenerator.cc:108-185).  ``include_events=False`` replicates
        the very first frame of a session: the reference captures attack
        events during step() only once rendering has been ACTIVATED
        (GridWorld.cc:484 ``if (!first_render)``), so the frame rendered
        right after the first activation carries none."""
        spec = env.spec
        host = env._frame_host(wall=self.frame_ct == 0)
        out = []
        if self.frame_ct == 0:
            ys, xs = np.nonzero(host["wall"])
            out.append("W %d" % len(xs))
            out.extend("%d %d" % p for p in zip(xs.tolist(), ys.tolist()))

        events = attack_events(env, host) if include_events else []

        # agents (can_absorb types render only absorbed members,
        # RenderGenerator.cc:137-163)
        hp = host["hp"]
        agent_lines = []
        for i, g in enumerate(spec.groups):
            t = g.type
            sl = slice(g.offset, g.offset + g.cap)
            keep = host["active"][sl]
            if t.can_absorb:
                keep = keep & host["absorbed"][sl]
            idx = np.nonzero(keep)[0]
            hp_pct = np.clip((100 * hp[sl] / t.hp).astype(np.int64), 0, 100)
            rows = np.stack([
                host["id"][sl][idx], hp_pct[idx],
                _DIR2ANGLE[host["dir"][sl][idx]], host["x"][sl][idx],
                host["y"][sl][idx], np.full(len(idx), i)], axis=1)
            agent_lines.extend("%d %d %d %d %d %d" % tuple(r)
                               for r in rows.tolist())

        out.append("F %d %d 0" % (len(agent_lines), len(events)))
        out.extend(agent_lines)
        out.extend("0 %d %d %d" % e for e in events)
        _write(os.path.join(self.save_dir, "video_%d.txt" % self.file_ct),
               self.frame_ct == 0, out)

        env._attack_events = np.asarray(
            [[e[0], e[1], e[2]] for e in events], np.int32
        ).reshape(-1, 3)

        self.frame_ct += 1
        if self.frame_ct > self.frame_per_file:
            self.frame_ct = 0
            self.file_ct += 1


class SnakeRenderGenerator:
    """Replay dumper for DiscreteSnake in the reference snake format
    (reference: src/discrete_snake/RenderGenerator.cc:53-206):

    - ``config.json`` + ``static.map`` (wall list) at setup;
    - per frame ``F n 0 0`` then one line per food cell (group 1) and per
      snake body segment tail->head (body group 2, head group 0), each
      ``id hp dir x y group`` with hp=100 and dir=270 like the reference.
    """

    def __init__(self, save_dir: str, frame_per_file: int = 10000):
        self.save_dir = save_dir
        self.frame_per_file = frame_per_file
        self.file_ct = 0
        self.frame_ct = 0
        self.id_ct = 0
        os.makedirs(save_dir, exist_ok=True)

    def gen_config(self, env):
        """reference: RenderGenerator::gen_config (snake,
        RenderGenerator.cc:53-144)"""
        # groups: food, snake head, snake body (reference color table)
        groups = [(1, 1, c, alpha, 0, 0, 0, 0, 0)
                  for c, alpha in (((64, 64, 192), 1), ((192, 64, 64), 1),
                                   ((64, 192, 64), 0.9))]
        _write(os.path.join(self.save_dir, "config.json"), True,
               _config_lines(env.width, env.height, groups))

        st = getattr(env, "state", None)  # the sequential snake has none
        wall = st.cell_wall.cpu().numpy() if st is not None else \
            env.wall_mask()
        ys, xs = np.nonzero(wall)
        _write(os.path.join(self.save_dir, "static.map"), True,
               ["%d" % len(xs)] + ["%d %d" % p
                                   for p in zip(xs.tolist(), ys.tolist())])

    def render_a_frame(self, env):
        """reference: RenderGenerator::render_a_frame (snake,
        RenderGenerator.cc:146-203); the fast snake's state in one copy"""
        st = env.state
        alive, length, head, body_x, body_y, food = to_host([
            st.active & st.alive, st.length, st.head, st.body_x, st.body_y,
            st.cell_food > 0])
        L = body_x.shape[1]

        fys, fxs = np.nonzero(food)
        bodies = []
        for s in np.nonzero(alive)[0]:
            n = int(length[s])
            bodies.append([
                (int(body_x[s, (int(head[s]) - k) % L]),
                 int(body_y[s, (int(head[s]) - k) % L]))
                for k in range(n - 1, -1, -1)  # tail -> head
            ])
        self.write_frame(list(zip(fxs.tolist(), fys.tolist())), bodies)

    def write_frame(self, foods, bodies):
        """Shared frame writer: ``foods`` = [(x, y), ...]; ``bodies`` =
        one list per live snake of (x, y) segments tail -> head (the last
        segment is the head, rendered as group 0 — the reference walks the
        deque rbegin->rend, RenderGenerator.cc:187-197)."""
        n_snake = sum(len(b) for b in bodies)
        out = ["F %d 0 0" % (n_snake + len(foods))]

        hp, angle = 100, 270
        for fx, fy in foods:
            out.append("%d %d %d %d %d 1" % (self.id_ct, hp, angle, fx, fy))
            self.id_ct += 1
        for body in bodies:
            for k, (bx, by) in enumerate(body):
                group = 0 if k == len(body) - 1 else 2
                out.append("%d %d %d %d %d %d" % (
                    self.id_ct, hp, angle, bx, by, group))
                self.id_ct += 1

        _write(os.path.join(self.save_dir, "video_%d.txt" % self.file_ct),
               self.frame_ct == 0, out)

        self.frame_ct += 1
        if self.frame_ct > self.frame_per_file:
            self.frame_ct = 0
            self.file_ct += 1
