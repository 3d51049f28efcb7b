"""Sequential parity engine: reference-order semantics on the host (a copy
of ``magent_tpu/core/seq_engine.py``; NumPy only, no torch).

The fast engine (:mod:`engine`) resolves each phase as simultaneous batched
array ops; the reference C++ engine mutates the map *in order* (attacks in a
Fisher-Yates-shuffled buffer, moves/turns in buffer order), so outcomes can
differ when several agents contend for one cell or one target.  This module
replays the reference's exact sequential semantics in NumPy:

- attack loop with the minstd-shuffled buffer and mid-phase death checks
  (reference: GridWorld.cc:464-517, Map::get_attack_obj/do_attack
  Map.cc:209-310);
- starve pass (GridWorld.cc:519-542, Agent::starve GridWorld.h:194-201);
- turn and move loops in slot order with chain moves allowed
  (GridWorld.cc:544-613, Map::do_move/do_turn Map.cc:313-406);
- the reward-rule DFS with involved-flags and inferred bindings
  (RewardEngine.cc:150-214 compilation, :216-443 evaluation);
- the group-extinction done check including its dead_ct bookkeeping quirks
  (GridWorld.cc:618-630: absorb deaths don't count toward dead_ct).

It is a *verification mode*: used by the parity test-suite to check the fast
engine against golden trajectories dumped from the reference C++ engine, and
as a differential-testing oracle.  Throughput is irrelevant here.  The
port's ``GridWorld(engine_mode="sequential")`` copies the state to the host,
steps it here, and copies it back; its observation stays on the device.
"""

from __future__ import annotations

import numpy as np

from .. import spec as speclib
from ..config import AgentSymbol, EventNode
from ..spec import (NORTH, OP_ALIGN, OP_AND, OP_AT, OP_ATTACK,
                    OP_COLLIDE, OP_DIE, OP_IN, OP_IN_A_LINE, OP_KILL, OP_NOT,
                    OP_OR, SOUTH, WEST)

LOGIC_OPS = (OP_AND, OP_OR, OP_NOT)
BINARY_OPS = (OP_KILL, OP_COLLIDE, OP_ATTACK)

f32 = np.float32  # the reference engine computes hp/rewards in C `float`;
# per-op float32 rounding must be replicated or kill thresholds drift


def _rotate_delta(d, dx, dy):
    if d == NORTH:
        return dx, dy
    if d == SOUTH:
        return -dx, -dy
    if d == WEST:
        return dy, -dx
    return -dy, dx  # EAST


def _save_to_real(x, y, d, w, l):
    if d == NORTH:
        return x, y
    if d == SOUTH:
        return x + w - 1, y + l - 1
    if d == WEST:
        return x, y + w - 1
    return x + l - 1, y  # EAST


def _real_to_save(x, y, d, w, l):
    if d == NORTH:
        return x, y
    if d == SOUTH:
        return x - w + 1, y - l + 1
    if d == WEST:
        return x, y - w + 1
    return x - l + 1, y  # EAST


def _rela_to_abs(cx, cy, d, rx, ry):
    if d == NORTH:
        return cx + rx, cy + ry
    if d == SOUTH:
        return cx - rx, cy - ry
    if d == WEST:
        return cx + ry, cy - rx
    return cx - ry, cy + rx  # EAST


def _size_for_dir(d, w, l):
    return (w, l) if d in (NORTH, SOUTH) else (l, w)


class _Symbols:
    """Reference symbol numbering: first-visit order over all rules
    (reference: python/magent/gridworld.py:_serialize_event_exp)."""

    def __init__(self, rules):
        self.order = []

        def visit(node):
            for item in node.inputs:
                if isinstance(item, EventNode):
                    visit(item)
                elif isinstance(item, AgentSymbol):
                    if item not in self.order:
                        self.order.append(item)

        for rule in rules:
            visit(rule["on"])
            for r in rule["receivers"]:
                if r not in self.order:
                    self.order.append(r)

    def index(self, sym):
        return self.order.index(sym)


def _related_and_infer(node, sym_index):
    """(related symbols sorted by registration number, infer map sub->obj)
    — reference: RewardEngine.cc:collect_related_symbol (:71-100)."""
    related = set()
    infer = {}

    def walk(n):
        if n.op in (OP_AND, OP_OR):
            walk(n.inputs[0])
            walk(n.inputs[1])
        elif n.op == OP_NOT:
            walk(n.inputs[0])
        elif n.op in BINARY_OPS:
            related.add(n.inputs[0])
            related.add(n.inputs[1])
            # std::map::insert keeps the first mapping for a key
            infer.setdefault(n.inputs[0], n.inputs[1])
        else:
            related.add(n.inputs[0])

    walk(node)
    return sorted(related, key=sym_index), infer


class SequentialEngine:
    """Reference-order step for a compiled spec, acting on host arrays."""

    def __init__(self, spec: speclib.GameSpec):
        self.spec = spec
        raw = [
            dict(on=r[0], receivers=r[1], values=r[2], terminal=r[3])
            for r in spec.reward_rules
        ]
        self.symbols = _Symbols(raw)
        self.rules = []
        for r in raw:
            related, infer = _related_and_infer(r["on"], self.symbols.index)
            # first pass: inferable pairs; second: the rest
            # (reference: RewardEngine.cc:157-189)
            input_symbols, infer_obj, added = [], [], set()
            for sym in related:
                if sym in added:
                    continue
                if sym in infer:
                    input_symbols.append(sym)
                    infer_obj.append(infer[sym])
                    added.add(sym)
                    added.add(infer[sym])
            for sym in related:
                if sym not in added:
                    input_symbols.append(sym)
                    infer_obj.append(None)
            self.rules.append(dict(r, input_symbols=input_symbols,
                                   infer_obj=infer_obj))

    # ------------------------------------------------------------------ step
    def step(self, S, lcg):
        """Advance one step.  ``S`` is a dict of host arrays (x, y, dir, hp,
        active, dead, absorbed, last_action, next_reward, last_op, op_obj,
        cell_slot, cell_wall, cell_food, group_reward, dead_ct); ``lcg`` is
        the shared HostLCG.  Returns done."""
        spec = self.spec
        gof = spec.group_of_slot

        # ---- collect buffers in slot order (set_action buffers,
        # GridWorld.cc:403-454; groups stepped in handle order)
        attack_buf, turn_buf, move_buf = [], [], []
        for g in spec.groups:
            t = g.type
            for k in range(g.offset, g.offset + g.cap):
                if not S["active"][k]:
                    continue
                act = int(S["last_action"][k])
                if t.attack_base <= act < t.n_action:
                    attack_buf.append((k, act - t.attack_base))
                elif spec.turn_mode and t.turn_base <= act < t.attack_base:
                    turn_buf.append((k, act))  # absolute (see turn quirk below)
                elif 0 <= act < t.turn_base:
                    move_buf.append((k, act))

        # ---- Fisher-Yates shuffle with the engine rng (GridWorld.cc:464-468)
        # exact per-step render attack events, in buffer order, recorded the
        # way the reference does (GridWorld.cc:476-486: after the mid-phase
        # dead check, before the target checks — blank/out-of-board attacks
        # included)
        self.attack_events = []
        for i in range(len(attack_buf)):
            j = lcg() % (i + 1)
            attack_buf[i], attack_buf[j] = attack_buf[j], attack_buf[i]

        for slot, att in attack_buf:
            self._do_attack(S, slot, att)

        # ---- starve pass (GridWorld.cc:519-542)
        for g in spec.groups:
            t = g.type
            for k in range(g.offset, g.offset + g.cap):
                if not S["active"][k] or S["dead"][k]:
                    continue
                if t.step_recover > 0:
                    S["hp"][k] = min(f32(t.hp), f32(S["hp"][k]) + f32(t.step_recover))
                else:
                    # starve() calls be_attack(-step_recover) (GridWorld.h:194-208)
                    S["hp"][k] = f32(S["hp"][k]) - f32(-f32(t.step_recover))
                    if S["hp"][k] < 0.0:
                        S["dead"][k] = True
                        S["next_reward"][k] = f32(t.dead_penalty)
                        self._remove_body(S, k)
                        S["dead_ct"][gof[k]] += 1

        # ---- turns then moves, buffer (slot) order
        if spec.turn_mode:
            for slot, act_abs in turn_buf:
                if S["dead"][slot]:
                    continue
                # reference quirk: the turn buffer stores the ABSOLUTE
                # action (act - move_base with move_base = 0,
                # GridWorld.cc:431/449), do_turn's body rotation treats any
                # wise != -1 as clockwise (Map.cc:380-386), while the facing
                # advances by the RAW wise: new_dir = (dir + 2*act - 1) % 4
                # (Map.cc:366)
                self._do_turn(S, slot, 2 * act_abs - 1)
        for slot, act in move_buf:
            if S["dead"][slot] or S["absorbed"][slot]:
                continue
            self._do_move(S, slot, act)

        # ---- reward rules (GridWorld.cc:681-692 + RewardEngine.cc:373-443)
        terminal = self._calc_reward(S)

        # ---- done (GridWorld.cc:618-630)
        done = terminal
        for g in spec.groups:
            n = int(np.sum(S["active"][g.offset : g.offset + g.cap]))
            if n - int(S["dead_ct"][g.group_id]) <= 0:
                done = True
        return done

    # ----------------------------------------------------------------- phases
    def _occupier(self, S, x, y):
        """(kind, payload): 'agent' slot, 'food', or None."""
        if S["cell_slot"][y, x] >= 0:
            return "agent", int(S["cell_slot"][y, x])
        if self.spec.food_mode and S["cell_food"][y, x] >= 0.0:
            return "food", None
        return None, None

    def _do_attack(self, S, slot, att):
        spec = self.spec
        t = spec.groups[spec.group_of_slot[slot]].type
        if S["dead"][slot]:
            return
        d = int(S["dir"][slot])
        dx, dy = t.attack_range.num2delta(att)
        ax, ay = _save_to_real(int(S["x"][slot]), int(S["y"][slot]), d,
                               t.width, t.length)
        tx, ty = _rela_to_abs(ax, ay, d, t.att_x_offset + dx, t.att_y_offset + dy)
        self.attack_events.append((int(S["id"][slot]), int(tx), int(ty)))
        W, H = spec.width, spec.height
        penalty = t.attack_penalty
        if not (0 <= tx < W and 0 <= ty < H):
            S["next_reward"][slot] = f32(S["next_reward"][slot]) + f32(penalty)
            return
        kind, obj = self._occupier(S, tx, ty)
        if kind is None:
            S["next_reward"][slot] = f32(S["next_reward"][slot]) + f32(penalty)
            return
        if kind == "agent":
            og = spec.group_of_slot[obj]
            if not t.attack_in_group and og == spec.group_of_slot[slot]:
                S["next_reward"][slot] = f32(S["next_reward"][slot]) + f32(penalty)
                return
            ot = spec.groups[og].type
            reward = f32(0.0)
            S["hp"][obj] = f32(S["hp"][obj]) - f32(t.damage)
            if S["hp"][obj] < 0.0:
                S["dead"][obj] = True
                S["next_reward"][obj] = f32(ot.dead_penalty)
                S["last_op"][slot] = OP_KILL
                S["op_obj"][slot] = obj
                self._remove_body(S, obj)
                S["dead_ct"][og] += 1
                S["hp"][slot] = min(f32(t.hp), f32(S["hp"][slot]) + f32(ot.kill_supply))
                if spec.food_mode:
                    S["cell_food"][ty, tx] = f32(ot.food_supply)
                reward = f32(ot.kill_reward)
            else:
                S["last_op"][slot] = OP_ATTACK
                S["op_obj"][slot] = obj
            S["next_reward"][slot] = f32(S["next_reward"][slot]) + (reward + f32(penalty))
        else:  # food
            add = min(f32(t.eat_ability), f32(S["cell_food"][ty, tx]))
            S["hp"][slot] = min(f32(t.hp), f32(S["hp"][slot]) + add)
            S["cell_food"][ty, tx] = f32(S["cell_food"][ty, tx]) - add
            if S["cell_food"][ty, tx] < 0.1:
                # deletion on eat (Map.cc:299-303): cell becomes blank
                S["cell_food"][ty, tx] = -1.0
            S["next_reward"][slot] = f32(S["next_reward"][slot]) + (f32(0.0) + f32(penalty))

    def _body_rect(self, S, slot):
        t = self.spec.groups[self.spec.group_of_slot[slot]].type
        bw, bh = _size_for_dir(int(S["dir"][slot]), t.width, t.length)
        return int(S["x"][slot]), int(S["y"][slot]), bw, bh

    def _remove_body(self, S, slot):
        x, y, bw, bh = self._body_rect(S, slot)
        region = S["cell_slot"][y : y + bh, x : x + bw]
        region[region == slot] = -1

    def _is_blank(self, S, x, y, bw, bh, self_slot):
        spec = self.spec
        if x < 0 or y < 0 or x + bw >= spec.width or y + bh >= spec.height:
            return False
        for i in range(bw):
            for j in range(bh):
                if S["cell_wall"][y + j, x + i]:
                    return False
                occ = S["cell_slot"][y + j, x + i]
                if occ >= 0 and occ != self_slot:
                    return False
                if spec.food_mode and S["cell_food"][y + j, x + i] >= 0.0:
                    return False
        return True

    def _get_collide(self, S, x, y, bw, bh, self_slot):
        """First colliding agent in x-major scan order (Map.cc:486-501)."""
        spec = self.spec
        if x < 0 or y < 0 or x + bw >= spec.width or y + bh >= spec.height:
            return None
        for i in range(bw):
            for j in range(bh):
                occ = S["cell_slot"][y + j, x + i]
                if occ >= 0 and occ != self_slot:
                    return int(occ)
        return None

    def _fill_body(self, S, slot, x, y, bw, bh):
        S["cell_slot"][y : y + bh, x : x + bw] = slot
        S["x"][slot], S["y"][slot] = x, y

    def _do_move(self, S, slot, act):
        spec = self.spec
        g = spec.group_of_slot[slot]
        t = spec.groups[g].type
        d = int(S["dir"][slot])
        dx, dy = t.move_range.num2delta(act)
        ddx, ddy = _rotate_delta(d, dx, dy)
        nx, ny = int(S["x"][slot]) + ddx, int(S["y"][slot]) + ddy
        bw, bh = _size_for_dir(d, t.width, t.length)

        if self._is_blank(S, nx, ny, bw, bh, slot):
            x, y, _, _ = self._body_rect(S, slot)
            region = S["cell_slot"][y : y + bh, x : x + bw]
            region[region == slot] = -1
            self._fill_body(S, slot, nx, ny, bw, bh)
            return
        obj = self._get_collide(S, nx, ny, bw, bh, slot)
        if obj is None:
            return
        ot = spec.groups[spec.group_of_slot[obj]].type
        if ot.can_absorb:
            if not S["absorbed"][obj]:
                S["absorbed"][obj] = True
                S["hp"][obj] = f32(S["hp"][obj]) * f32(2.0)
                S["dead"][slot] = True  # absorb death: dead_ct NOT bumped
                self._remove_body(S, slot)
                S["last_op"][slot] = OP_COLLIDE
                S["op_obj"][slot] = obj
        else:
            S["last_op"][slot] = OP_COLLIDE
            S["op_obj"][slot] = obj

    def _do_turn(self, S, slot, wise):
        spec = self.spec
        t = spec.groups[spec.group_of_slot[slot]].type
        d = int(S["dir"][slot])
        new_d = (d + wise + 4) % 4
        bw, bh = _size_for_dir(d, t.width, t.length)
        ax, ay = _save_to_real(int(S["x"][slot]), int(S["y"][slot]), d,
                               t.width, t.length)
        anchor_x, anchor_y = _rela_to_abs(ax, ay, d, t.turn_x_offset,
                                          t.turn_y_offset)
        dx, dy = ax - anchor_x, ay - anchor_y
        if wise == -1:
            nx, ny = anchor_x - dy, anchor_y + dx
        else:
            nx, ny = anchor_x + dy, anchor_y - dx
        sx, sy = _real_to_save(nx, ny, new_d, t.width, t.length)
        nbw, nbh = _size_for_dir(new_d, t.width, t.length)
        if self._is_blank(S, sx, sy, nbw, nbh, slot):
            x, y, _, _ = self._body_rect(S, slot)
            region = S["cell_slot"][y : y + bh, x : x + bw]
            region[region == slot] = -1
            S["dir"][slot] = new_d
            self._fill_body(S, slot, sx, sy, nbw, nbh)

    # ----------------------------------------------------------------- rules
    def _group_members(self, S, g):
        """Slot list in agents-vector order (slot order, including agents
        that died this step — they leave the vector only at clear_dead)."""
        gs = self.spec.groups[g]
        return [k for k in range(gs.offset, gs.offset + gs.cap) if S["active"][k]]

    def _calc_reward(self, S):
        terminal = False
        involved = np.zeros(self.spec.n_agents_cap, bool)
        for rule in self.rules:
            binding = {}
            trig = self._calc_rule(S, rule, 0, binding, involved)
            if trig and rule["terminal"]:
                terminal = True
        return terminal

    def _calc_rule(self, S, rule, now, binding, involved):
        spec = self.spec
        syms = rule["input_symbols"]
        if now == len(syms):
            if self._calc_event(S, rule["on"], rule, binding):
                for sym, value in zip(rule["receivers"], rule["values"]):
                    if sym.is_all():
                        S["group_reward"][sym.group] = (
                            f32(S["group_reward"][sym.group]) + f32(value))
                    elif sym not in binding:
                        # the reference would dereference an unbound entity
                        # pointer here (RewardEngine.cc:387); fail loudly and
                        # consistently with the fast compiler's rejection
                        raise NotImplementedError(
                            "receiver symbol not involved in the "
                            "triggering event")
                    else:
                        S["next_reward"][binding[sym]] = (
                            f32(S["next_reward"][binding[sym]]) + f32(value))
                return True
            return False

        triggered = False
        sym = syms[now]
        infer = rule["infer_obj"][now]
        if sym.is_any():
            for k in self._group_members(S, sym.group):
                if involved[k]:
                    continue
                involved[k] = True
                binding[sym] = k
                if infer is not None:
                    obj = int(S["op_obj"][k])
                    if obj >= 0 and self._bind_check(S, infer, obj, binding):
                        triggered |= self._calc_rule(S, rule, now + 1,
                                                     binding, involved)
                else:
                    triggered |= self._calc_rule(S, rule, now + 1, binding,
                                                 involved)
                involved[k] = False
            binding.pop(sym, None)
        elif sym.is_all():
            if infer is not None:
                members = self._group_members(S, sym.group)
                if members:
                    obj = int(S["op_obj"][members[0]])
                    if obj >= 0 and self._bind_check(S, infer, obj, binding):
                        triggered |= self._calc_rule(S, rule, now + 1,
                                                     binding, involved)
            else:
                triggered |= self._calc_rule(S, rule, now + 1, binding, involved)
        else:  # deterministic index
            members = self._group_members(S, sym.group)
            if sym.index < len(members):
                k = members[sym.index]
                binding[sym] = k
                if infer is not None:
                    obj = int(S["op_obj"][k])
                    if obj >= 0 and self._bind_check(S, infer, obj, binding):
                        triggered |= self._calc_rule(S, rule, now + 1,
                                                     binding, involved)
                # reference quirk: a fixed-index symbol with NO inferable
                # object never recurses, so the rule can never fire
                # (RewardEngine.cc calc_rule deterministic branch has no
                # infer==null path, :432-441)
        return triggered

    def _bind_check(self, S, sym, obj_slot, binding):
        """reference: AgentSymbol::bind_with_check (RewardEngine.cc:14-23)"""
        if sym.group != self.spec.group_of_slot[obj_slot]:
            return False
        if not (sym.is_any() or sym.is_all()):
            members = self._group_members(S, sym.group)
            if sym.index >= len(members) or members[sym.index] != obj_slot:
                return False
        binding[sym] = obj_slot
        return True

    def _calc_event(self, S, node, rule, binding):
        op = node.op
        if op == OP_AND:
            return (self._calc_event(S, node.inputs[0], rule, binding)
                    and self._calc_event(S, node.inputs[1], rule, binding))
        if op == OP_OR:
            return (self._calc_event(S, node.inputs[0], rule, binding)
                    or self._calc_event(S, node.inputs[1], rule, binding))
        if op == OP_NOT:
            return not self._calc_event(S, node.inputs[0], rule, binding)

        sub = node.inputs[0]
        if op in BINARY_OPS:
            obj_slot = binding[node.inputs[1]]
            if sub.is_all():
                members = self._group_members(S, sub.group)
                return all(
                    S["last_op"][k] == op and S["op_obj"][k] == obj_slot
                    for k in members
                )
            k = binding[sub]
            return S["last_op"][k] == op and S["op_obj"][k] == obj_slot
        if op == OP_AT:
            x, y = node.inputs[1], node.inputs[2]
            if sub.is_all():
                return all(S["x"][k] == x and S["y"][k] == y
                           for k in self._group_members(S, sub.group))
            k = binding[sub]
            return S["x"][k] == x and S["y"][k] == y
        if op == OP_IN:
            x1, y1, x2, y2 = node.inputs[1:5]
            def inside(k):
                return (x1 < S["x"][k] < x2) and (y1 < S["y"][k] < y2)
            if sub.is_all():
                return all(inside(k) for k in self._group_members(S, sub.group))
            return inside(binding[sub])
        if op == OP_DIE:
            if sub.is_all():
                return all(S["dead"][k]
                           for k in self._group_members(S, sub.group))
            return bool(S["dead"][binding[sub]])
        if op == OP_IN_A_LINE:
            # contiguous row or column (RewardEngine.cc:262-296)
            members = self._group_members(S, sub.group)
            if len(members) < 2:
                return True
            xs = [int(S["x"][k]) for k in members]
            ys = [int(S["y"][k]) for k in members]
            if xs.count(xs[0]) == len(xs) and ys.count(ys[0]) != len(ys):
                return max(ys) - min(ys) + 1 == len(members)
            if ys.count(ys[0]) == len(ys) and xs.count(xs[0]) != len(xs):
                return max(xs) - min(xs) + 1 == len(members)
            return False
        if op == OP_ALIGN:
            # intended semantics: same-column + same-row group-mates of the
            # subject (the reference's counter updates are disabled dead
            # code, GridWorld.cc:955-970, so its ALIGN always sees zeros;
            # we implement the documented intent)
            k = binding[sub]
            members = self._group_members(S, sub.group)
            align = sum(1 for m in members if S["x"][m] == S["x"][k]) + \
                sum(1 for m in members if S["y"][m] == S["y"][k])
            return align > 1
        raise NotImplementedError("sequential engine: op %d" % op)
