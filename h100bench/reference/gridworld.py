"""A batch of lockstep gridworlds written straight from their rules.

The world of a configuration file (``configs/<config>.json``, key
``world``): MAgent's agent types (``python/magent/gridworld.py``'s
attributes), its circle ranges (``src/gridworld/Range.h``), its action
layout (the moves, then the attacks), its view channels and features
(``GridWorld.cc``'s ``get_observation``) and its ``attack`` reward rules,
on a fixed wall map and fixed start positions, every body facing north.

One step of every env at once (the lockstep definition):

1. attack: every live attacker names the cell of its attack action; the
   live body on that cell, if any and not of its own group, is its
   target.  Every attack costs the attacker its ``attack_penalty``.
   Each target takes its attackers one at a time in a random priority
   order (the high bits of MurmurHash3's finaliser of a fresh key word
   plus the slot times the golden ratio, the slot as tie-break): an
   attacker strikes while the target's hp, less the damage of the
   attackers before it, is still >= 0, and the strike that takes it below
   0 kills it.  A killer earns the target type's ``kill_reward``; the
   killed take their ``dead_penalty`` as reward.
2. starve: the live recover ``step_recover`` up to their hp (or starve,
   where it is negative).
3. move: the live movers all move at once.  A move to one's own place
   succeeds.  Any other move succeeds where its target rect lies inside
   the map, holds no wall and no other live body, and no lower slot moves
   onto any of its cells; a blocked mover collides with the body of the
   first occupied cell of its target rect (columns outer, rows inner), a
   mover that loses a cell with the lowest slot moving there.
4. reward rules, then done (a group with no live agent), and the next
   step's rewards and last ops cleared; a done env starts afresh from
   its key folded with 7.

Everything here runs with plain tensor operations on whole grids: one
occupancy grid per env, a claim grid filled by a scatter-min, and the
attack order resolved one attacker per target per round."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from . import threefry as tf

OP_KILL, OP_COLLIDE, OP_ATTACK, OP_NULL = 3, 6, 7, 11
NORTH = 3
GOLDEN = 0x9E3779B9
FIELDS = ("x", "y", "hp", "dead", "last_action", "last_reward",
          "next_reward", "last_op", "op_obj", "key", "step_ct")


def circle(radius, inner, parity):
    """A circle range: (mask [n, n] bool, offsets [(dx, dy), ...] of its
    cells in row-major order, offset of its first column and row)."""
    eps = 1e-8
    n = 2 * int(radius + eps) + parity
    c = int(radius)
    if n % 2 != parity:
        n += 1
    shift = 0.5 if parity == 0 else 0.0
    mask = np.zeros((n, n), bool)
    cells = []
    for i in range(n):
        for j in range(n):
            d = math.hypot(j - c + shift, i - c + shift)
            if inner - eps < d < radius + eps:
                mask[i, j] = True
                cells.append((j - c, i - c))
    return mask, cells, -c


class AgentType:
    def __init__(self, attr):
        a = dict(attr)
        self.w, self.l = int(a.get("width", 1)), int(a.get("length", 1))
        self.hp = float(a.get("hp", 1.0))
        get = lambda k: float(a.get(k, 0.0))  # noqa: E731
        self.damage, self.recover = get("damage"), get("step_recover")
        self.kill_supply, self.step_reward = get("kill_supply"), get("step_reward")
        self.kill_reward, self.dead_penalty = get("kill_reward"), get("dead_penalty")
        self.attack_penalty = get("attack_penalty")
        self.in_group = bool(a.get("attack_in_group", False))
        (kind, view_r), = a["view_range"].items()
        (kind2, att_r), = a["attack_range"].items()
        assert kind == kind2 == "circle"
        parity = self.w % 2
        self.view_mask, _, self.view_lo = circle(view_r, 0.0, parity)
        _, self.attacks, _ = circle(att_r, self.w / 2.0, parity)
        _, self.moves, _ = circle(float(a.get("speed", 1.0)), 0.0, 1)
        self.n_action = len(self.moves) + len(self.attacks)


class World:
    """``n_envs`` lockstep envs of the configuration's ``world`` on
    ``wall`` (a full [H, W] bool map, border included) from ``placements``
    (per group, [n, 2] rows (x, y)), on ``device``."""

    def __init__(self, world, n_envs, wall, placements, device):
        self.world, self.B, self.device = world, n_envs, device
        self.H = self.W = int(world["map_size"])
        s = world.get("settings", {})
        self.minimap = bool(s.get("minimap_mode", False))
        self.emb = int(s.get("embedding_size", 0))
        types = {k: AgentType(v) for k, v in world["agent_types"].items()}
        self.types = [types[g["type"]] for g in world["groups"]]
        self.caps = [int(g["n"]) for g in world["groups"]]
        self.offsets = list(np.cumsum([0] + self.caps[:-1]))
        self.G, self.A = len(self.caps), sum(self.caps)
        self.MB = max(max(t.w, t.l) for t in self.types)
        gof = np.repeat(np.arange(self.G), self.caps)

        def per_slot(f, dtype=torch.float32):
            return torch.as_tensor(np.array([f(self.types[g]) for g in gof]),
                                   dtype=dtype, device=device)

        self.gof = torch.as_tensor(gof, device=device)
        self.hp_max = per_slot(lambda t: t.hp)
        self.w = per_slot(lambda t: t.w, torch.int64)
        self.l = per_slot(lambda t: t.l, torch.int64)
        self.damage = per_slot(lambda t: t.damage)
        self.recover = per_slot(lambda t: t.recover)
        self.step_reward = per_slot(lambda t: t.step_reward)
        self.dead_penalty = per_slot(lambda t: t.dead_penalty)
        self.attack_penalty = per_slot(lambda t: t.attack_penalty)
        self.in_group = per_slot(lambda t: t.in_group, torch.bool)
        self.n_move = per_slot(lambda t: len(t.moves), torch.int64)
        self.n_action = per_slot(lambda t: t.n_action, torch.int64)
        self.g_kill_reward = torch.tensor([t.kill_reward for t in self.types],
                                          device=device)
        self.g_kill_supply = torch.tensor([t.kill_supply for t in self.types],
                                          device=device)
        # per slot and action: the move's (dx, dy), the attacked cell's
        # offset from the body's top-left (its centre, plus the range's)
        K = max(t.n_action for t in self.types)
        table = np.zeros((len(gof), K, 4), np.int64)
        for a, g in enumerate(gof):
            t = self.types[g]
            for i, (dx, dy) in enumerate(t.moves):
                table[a, i, :2] = dx, dy
            for i, (dx, dy) in enumerate(t.attacks):
                table[a, len(t.moves) + i, 2:] = t.w // 2 + dx, t.l // 2 + dy
        self.table = torch.as_tensor(table, device=device)
        self.wall = torch.as_tensor(np.asarray(wall, bool), device=device)
        assert self.wall.shape == (self.H, self.W)
        self.x0 = torch.as_tensor(np.concatenate([p[:, 0] for p in placements]),
                                  device=device)
        self.y0 = torch.as_tensor(np.concatenate([p[:, 1] for p in placements]),
                                  device=device)
        assert self.x0.shape == (self.A,)
        A = self.A
        slot_bits = max(1, (A - 1).bit_length())
        self.prio_shift = (32 - (31 - slot_bits), slot_bits)
        self.slots = torch.arange(A, device=device)

    # -------------------------------------------------------------- states
    def fresh(self, keys):
        """Fresh envs, one per key of ``keys`` [k, 2]."""
        k = len(keys)
        A, dev = self.A, self.device
        return SimpleNamespace(
            x=self.x0.expand(k, A).clone(), y=self.y0.expand(k, A).clone(),
            hp=self.hp_max.expand(k, A).clone(),
            dead=torch.zeros((k, A), dtype=torch.bool, device=dev),
            last_action=self.n_action.expand(k, A).clone(),
            last_reward=torch.zeros((k, A), device=dev),
            next_reward=self.step_reward.expand(k, A).clone(),
            last_op=torch.full((k, A), OP_NULL, device=dev),
            op_obj=torch.full((k, A), -1, device=dev),
            key=tf.split(keys)[:, 1],
            step_ct=torch.zeros(k, dtype=torch.int64, device=dev))

    def reset(self, key):
        return self.fresh(tf.split(key, self.B))

    @staticmethod
    def of(state):
        """The fields of a state of the program's (or any object with the
        same attributes), keys as ``uint32``."""
        out = {f: getattr(state, f) for f in FIELDS}
        out["key"] = out["key"].cpu().numpy().astype(np.uint32)
        return SimpleNamespace(**out)

    # ---------------------------------------------------------------- grid
    def body_cells(self, x, y, mask):
        """Every cell of the masked bodies' rects -> (flat cell [n], slot's
        row b [n], slot a [n])."""
        b, a = torch.nonzero(mask, as_tuple=True)
        cells = []
        for i in range(self.MB):
            for j in range(self.MB):
                inside = (i < self.w[a]) & (j < self.l[a])
                cy, cx = y[b, a] + j, x[b, a] + i
                cells.append((b[inside], a[inside], cy[inside] * self.W + cx[inside]))
        return [torch.cat(c) for c in zip(*cells)]

    def occupancy(self, x, y, live):
        """[B, H*W]: the slot of the live body on each cell, else -1."""
        occ = torch.full((x.shape[0], self.H * self.W), -1, device=self.device)
        b, a, cell = self.body_cells(x, y, live)
        occ[b, cell] = a
        return occ

    # -------------------------------------------------------------- actions
    def random_actions(self, key):
        """Uniform random actions [B, A] int32 from one key."""
        u = torch.as_tensor(tf.uniform(key, (self.B, self.A)), device=self.device)
        return (u * self.n_action.float()).to(torch.int32)

    # ----------------------------------------------------------------- step
    def transition(self, s, actions):
        """-> (next state, rewards [B, A], alive [B, A], done [B])."""
        B, A, H, W = s.x.shape[0], self.A, self.H, self.W
        dev = self.device
        act = actions.to(dev).long()
        x, y, hp, dead = s.x.long(), s.y.long(), s.hp.float(), s.dead
        reward = s.next_reward.float()
        last_op, op_obj = s.last_op.long(), s.op_obj.long()
        halves = tf.split(s.key)
        new_key = halves[:, 0]
        word = np.asarray(halves[:, 1, 0], np.uint64)[:, None]
        rank = tf.fmix32(((word + np.arange(A, dtype=np.uint64) * GOLDEN)
                          % 2**32).astype(np.uint32)).astype(np.int64)
        hi, lo = self.prio_shift
        prio = torch.as_tensor((rank >> hi) << lo, device=dev) + self.slots
        rows = torch.arange(B, device=dev)[:, None]

        # 1. attack
        live = ~dead
        occ = self.occupancy(x, y, live)
        is_attack = live & (act >= self.n_move) & (act < self.n_action)
        off = self.table[self.slots, act.clamp(0, self.table.shape[1] - 1)]
        tx, ty = x + off[..., 2], y + off[..., 3]
        on_map = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H)
        tgt = torch.where(is_attack & on_map,
                          occ[rows, (ty * W + tx).clamp(0, H * W - 1)], -1)
        valid = (tgt >= 0) & (self.in_group | (self.gof[tgt.clamp(0)] != self.gof))
        reward = reward + torch.where(is_attack, self.attack_penalty, 0.0)
        tgt_k = torch.where(valid, tgt, A)
        hp_t = torch.cat([hp, torch.zeros((B, 1), device=dev)], 1)
        hp_t = hp_t.gather(1, tgt_k)
        before = torch.zeros((B, A + 1), device=dev)
        applied = torch.zeros((B, A + 1), device=dev)
        acted = torch.zeros_like(valid)
        killer = torch.zeros_like(valid)
        pending = valid.clone()
        big = torch.iinfo(torch.int64).max
        while bool(pending.any()):
            key_ = torch.where(pending, prio, big)
            first = torch.full((B, A + 1), big, device=dev).scatter_reduce(
                1, tgt_k, key_, "amin")
            me = pending & (key_ == first.gather(1, tgt_k))
            done_before = before.gather(1, tgt_k)
            strikes = me & (hp_t - done_before >= 0.0)
            kills = strikes & (hp_t - (done_before + self.damage) < 0.0)
            acted |= strikes
            killer |= kills
            idx = torch.where(me, tgt_k, A)
            before.scatter_add_(1, idx, torch.where(me, self.damage, 0.0))
            applied.scatter_add_(1, torch.where(strikes, tgt_k, A),
                                 torch.where(strikes, self.damage, 0.0))
            pending &= ~me
        applied = applied[:, :A]
        hp = hp - applied
        died = (applied > 0.0) & (hp < 0.0) & live
        tg = self.gof[tgt.clamp(0)]
        reward = reward + torch.where(killer, self.g_kill_reward[tg], 0.0)
        hp = torch.where(killer, torch.minimum(self.hp_max,
                                               hp + self.g_kill_supply[tg]), hp)
        reward = torch.where(died, self.dead_penalty, reward)
        last_op = torch.where(killer, OP_KILL, torch.where(acted, OP_ATTACK, last_op))
        op_obj = torch.where(acted, tgt, op_obj)
        dead = dead | died

        # 2. starve
        live = ~dead
        up = torch.minimum(self.hp_max, hp + self.recover)
        down = hp + self.recover
        hp = torch.where(live, torch.where(self.recover > 0, up, down), hp)
        starved = live & (self.recover <= 0) & (hp < 0.0)
        reward = torch.where(starved, self.dead_penalty, reward)
        dead = dead | starved

        # 3. move
        live = ~dead
        occ = self.occupancy(x, y, live)
        is_move = live & (act >= 0) & (act < self.n_move)
        off = self.table[self.slots, act.clamp(0, self.table.shape[1] - 1)]
        nx, ny = x + off[..., 0], y + off[..., 1]
        inside = (nx >= 0) & (ny >= 0) & (nx + self.w < W) & (ny + self.l < H)
        stay = is_move & inside & (nx == x) & (ny == y)
        ask = is_move & inside & ~stay
        walled = torch.zeros_like(ask)
        hit = torch.full_like(x, -1)  # first other body in the target rect
        scan = []  # (in rect, flat cell) of the target rect, columns outer
        for i in range(self.MB):
            for j in range(self.MB):
                cell = ((ny + j).clamp(0, H - 1) * W + (nx + i).clamp(0, W - 1))
                in_rect = ask & (i < self.w) & (j < self.l)
                scan.append((in_rect, cell))
                walled |= in_rect & self.wall.reshape(-1)[cell]
                o = occ[rows, cell]
                other = in_rect & (o >= 0) & (o != self.slots)
                hit = torch.where((hit < 0) & other, o, hit)
        blank = ask & (hit < 0) & ~walled
        claim = torch.full((B, H * W + 1), A, device=dev)
        for in_rect, cell in scan:
            claim.scatter_reduce_(1, torch.where(in_rect & blank, cell, H * W),
                                  self.slots.expand(B, A), "amin")
        lose_to = torch.full_like(x, -1)
        for in_rect, cell in scan:
            c = claim[rows, cell]
            lost = in_rect & blank & (c != self.slots)
            lose_to = torch.where((lose_to < 0) & lost, c, lose_to)
        wins = blank & (lose_to < 0)
        moved = wins | stay
        obj = torch.where(blank & ~wins, lose_to, torch.where(ask & (hit >= 0), hit, -1))
        collide = is_move & ~moved & inside & (obj >= 0)
        x, y = torch.where(moved, nx, x), torch.where(moved, ny, y)
        last_op = torch.where(collide, OP_COLLIDE, last_op)
        op_obj = torch.where(collide, obj, op_obj)

        # 4. reward rules: each attack of a subject on an object pays them
        for rule in self.world["reward_rules"]:
            assert rule["event"] == "attack"
            sg, og = rule["subject"], rule["object"]
            on = ((self.gof == sg) & (last_op == OP_ATTACK) & (op_obj >= 0)
                  & (self.gof[op_obj.clamp(0)] == og))
            for who, val in zip(rule["receiver"], rule["value"]):
                if who == sg:
                    reward = reward + torch.where(on, float(val), 0.0)
                if who == og:
                    got = torch.zeros((B, A + 1), device=dev).scatter_add_(
                        1, torch.where(on, op_obj, A), torch.where(on, float(val), 0.0))
                    reward = reward + got[:, :A]
        alive = ~dead
        done = torch.stack([alive[:, o:o + c].sum(1) == 0 for o, c in
                            zip(self.offsets, self.caps)], 1).any(1)
        nxt = SimpleNamespace(
            x=x, y=y, hp=hp, dead=dead, last_action=act, last_reward=reward,
            next_reward=torch.where(alive, self.step_reward, 0.0),
            last_op=torch.full_like(last_op, OP_NULL),
            op_obj=torch.full_like(op_obj, -1), key=new_key,
            step_ct=s.step_ct.long() + 1)
        if bool(done.any()):
            idx = torch.nonzero(done)[:, 0]
            fresh = self.fresh(tf.fold_in(new_key[idx.cpu().numpy()], 7))
            for f in FIELDS:
                v = getattr(nxt, f)
                if f == "key":
                    v = v.copy()
                    v[idx.cpu().numpy()] = fresh.key
                else:
                    v = v.clone()
                    v[idx] = getattr(fresh, f)
                setattr(nxt, f, v)
        return nxt, reward, alive, done

    # ------------------------------------------------------------- observe
    def observe(self, s, group):
        """-> (views [B, cap, vh, vw, C] float32, features [B, cap, F])."""
        t = self.types[group]
        G, H, W = self.G, self.H, self.W
        B = s.x.shape[0]
        dev = self.device
        o, cap = self.offsets[group], self.caps[group]
        x, y, live = s.x.long(), s.y.long(), ~s.dead
        scale = 3 if self.minimap else 2
        C = 1 + G * scale
        vh, vw = t.view_mask.shape
        pad = max(max(tt.view_mask.shape) for tt in self.types) + self.MB
        # the observer's channel image, padded off the map with zeros
        img = torch.zeros((B, H + 2 * pad, W + 2 * pad, C), device=dev)
        img[:, pad:pad + H, pad:pad + W, 0] = self.wall.float()
        b, a, cell = self.body_cells(x, y, live)
        ch = 1 + ((self.gof[a] - group) % G) * scale
        cy, cx = cell // W + pad, cell % W + pad
        img[b, cy, cx, ch] = 1.0
        img[b, cy, cx, ch + 1] = s.hp.float()[b, a] / self.hp_max[a]
        sl = slice(o, o + cap)
        top = y[:, sl] + t.l // 2 + t.view_lo + pad
        left = x[:, sl] + t.w // 2 + t.view_lo + pad
        mask = torch.as_tensor(t.view_mask, device=dev)
        view = torch.zeros((B, cap, vh, vw, C), device=dev)
        bb = torch.arange(B, device=dev)[:, None]
        for r in range(vh):
            for c in range(vw):
                if mask[r, c]:
                    view[:, :, r, c] = img[bb, top + r, left + c]
        if self.minimap:
            # the map pooled to the view's size, per group: each pooled
            # cell's share of the group's live agents, and a 1 on one's own
            sh, sw = -(-H // vh), -(-W // vw)
            py, px = (y // sh).clamp(max=vh - 1), (x // sw).clamp(max=vw - 1)
            for gg in range(G):
                m = live & (self.gof == gg)
                cnt = torch.zeros((B, vh * vw), device=dev).scatter_add_(
                    1, py * vw + px, m.float())
                share = cnt / m.sum(1, keepdim=True).clamp(min=1).float()
                view[..., 1 + ((gg - group) % G) * scale + 2] += share.reshape(
                    B, 1, vh, vw)
            own = (py[:, sl] * vw + px[:, sl])[..., None] == torch.arange(
                vh * vw, device=dev)
            view[..., 3::scale] += own.reshape(B, cap, vh, vw, 1).float()
        feats = []
        if self.emb:
            ids = self.slots[sl]
            feats.append(((ids[:, None] >> torch.arange(self.emb, device=dev)) & 1)
                         .float().expand(B, cap, self.emb))
        feats.append((s.last_action[:, sl, None].long() == torch.arange(
            t.n_action, device=dev)).float())
        feats.append(s.last_reward[:, sl, None].float())
        if self.minimap:
            feats.append(x[:, sl, None].float() / W)
            feats.append(y[:, sl, None].float() / H)
        return view, torch.cat(feats, -1)
