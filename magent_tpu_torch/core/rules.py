"""Reward-rule compiler: event ASTs -> batched boolean-mask evaluation
(port of ``magent_tpu/core/rules.py``).

The reference evaluates reward rules with a DFS over symbol bindings
(reference: src/gridworld/RewardEngine.cc:373-443) where 'any' symbols
iterate every agent of a group, object symbols are inferred from the
subject's ``last_op``/``op_obj`` pair (RewardEngine.cc:150-189), and each
successful binding pays the receivers once.  Each rule compiles once into
one of three vectorized plans, evaluated on ``[B, A]`` tensors with the env
axis written out (the JAX package vmaps each env's evaluation):

- :class:`SingleSubjectRule` — one 'any' subject symbol, optionally one
  inferred object symbol; per-subject-slot boolean masks (battle's rules);
- :class:`PairSharedObjectRule` — two 'any' subjects that both infer the
  same object (the double_attack pattern); binding counts per object turn
  the quantified pair-DFS into degree counting;
- :class:`GeneralRule` — every other rule shape: the exact chunked join.

:func:`compile_rules` routes a rule exactly as the JAX package does, so a
rule lands on the same plan in both packages.  The JAX package's
``MAGENT_RULES=general`` switch has no counterpart: build
:class:`GeneralRule` directly to force the general plan.
"""

from __future__ import annotations

import itertools
import math

import torch

from ..config import AgentSymbol, EventNode
from ..spec import (OP_ALIGN, OP_AND, OP_AT, OP_ATTACK, OP_COLLIDE, OP_DIE,
                    OP_IN, OP_IN_A_LINE, OP_KILL, OP_NOT, OP_OR)

BINARY_OPS = (OP_KILL, OP_COLLIDE, OP_ATTACK)
UNARY_OPS = (OP_AT, OP_IN, OP_DIE, OP_IN_A_LINE, OP_ALIGN)
LOGIC_OPS = (OP_AND, OP_OR, OP_NOT)


def _collect_symbols(node, out):
    for item in node.inputs:
        if isinstance(item, EventNode):
            _collect_symbols(item, out)
        elif isinstance(item, AgentSymbol):
            if item not in out:
                out.append(item)


def _collect_leaves(node, out):
    if node.op in LOGIC_OPS:
        for item in node.inputs:
            _collect_leaves(item, out)
    else:
        out.append(node)


class _BaseRule:
    def __init__(self, receivers, values, is_terminal):
        self.receivers = receivers
        self.values = values
        self.is_terminal = is_terminal
        self._gof_cache = {}

    def _gof(self, spec, device):
        """The spec's ``group_of_slot`` on ``device``, copied once."""
        if device not in self._gof_cache:
            self._gof_cache[device] = torch.as_tensor(spec.group_of_slot,
                                                      device=device)
        return self._gof_cache[device]


def _group_slice(spec, group):
    gs = spec.groups[group]
    return gs.offset, gs.cap


def _unary_pred(spec, state, leaf, gof):
    """Per-slot predicate ``[B, A]`` for a unary leaf (strict AT / IN bounds
    as RewardEngine.cc:297-335; DIE is the dead flag); ``gof`` is the
    spec's ``group_of_slot`` on the state's device."""
    if leaf.op == OP_AT:
        x, y = leaf.inputs[1], leaf.inputs[2]
        return (state.x == x) & (state.y == y)
    if leaf.op == OP_IN:
        x1, y1, x2, y2 = leaf.inputs[1:5]
        return (state.x > x1) & (state.x < x2) & (state.y > y1) & (state.y < y2)
    if leaf.op == OP_DIE:
        return state.dead
    if leaf.op == OP_IN_A_LINE:
        # group verdict (RewardEngine.cc:262-296) broadcast to every slot
        sym = leaf.inputs[0]
        member = (gof == sym.group) & state.active
        n = member.sum(-1, keepdim=True)
        big = 1 << 20
        xs_min = torch.where(member, state.x, big).amin(-1, keepdim=True)
        xs_max = torch.where(member, state.x, -big).amax(-1, keepdim=True)
        ys_min = torch.where(member, state.y, big).amin(-1, keepdim=True)
        ys_max = torch.where(member, state.y, -big).amax(-1, keepdim=True)
        col = (xs_min == xs_max) & (ys_max - ys_min + 1 == n)
        row = (ys_min == ys_max) & (xs_max - xs_min + 1 == n)
        return ((n < 2) | col | row).expand_as(state.x)
    raise NotImplementedError("unary op %d" % leaf.op)


def _group_slot_of(spec, idx):
    """(group, slot-in-group) of slot index ``idx`` from the contiguous
    per-group slot ranges."""
    og = torch.zeros_like(idx)
    base = torch.zeros_like(idx)
    for g in range(1, spec.n_groups):
        off = int(spec.group_offsets[g])
        hit = idx >= off
        og = og + hit.to(idx.dtype)
        base = torch.where(hit, off, base)
    return og, idx - base


def _gather_rows(per_slot, idx):
    """``per_slot[b, idx[b, ...]]`` for a per-slot tensor ``[B, n]`` and
    indices ``[B or 1, ...]`` (one env's indices serve every env)."""
    B = per_slot.shape[0]
    flat = idx.long().reshape(idx.shape[0], -1).expand(B, -1)
    return torch.gather(per_slot, 1, flat).reshape((B,) + idx.shape[1:])


def _add_at(values, idx, upd):
    """``values[b, idx[b, k]] += upd[b, k]`` in index order, index ``A``
    (the width of ``values``) dropped: the JAX package's scatter-add with
    ``mode="drop"`` into an existing array."""
    B, A = values.shape
    padded = torch.cat([values, values.new_zeros((B, 1))], 1)
    return padded.scatter_add_(1, idx.long(), upd)[:, :A]


class SingleSubjectRule(_BaseRule):
    """Rules over one 'any' subject symbol with at most one inferred object
    (``magent_tpu/core/rules.py:112-179``)."""

    def __init__(self, spec, on, subject, obj, receivers, values, is_terminal):
        super().__init__(receivers, values, is_terminal)
        if not subject.is_any():
            raise ValueError("SingleSubjectRule takes an 'any' subject")
        self.on = on
        self.subject = subject
        self.obj = obj

    def apply(self, spec, state, next_reward, group_reward):
        """-> (next_reward [B, A], group_reward [B, G], triggered [B])."""
        A = spec.n_agents_cap
        device = state.x.device
        g = self._gof(spec, device)
        in_subj = (g == self.subject.group) & state.active

        obj = self.obj
        if obj is not None:
            # binding: object inferred from the subject's op_obj
            # (RewardEngine.cc:405-409)
            oo = state.op_obj
            ok = (oo >= 0) & in_subj
            og_raw, oi = _group_slot_of(spec, oo.clamp(0, A - 1))
            og = torch.where(ok, og_raw, -1)
            bind = ok & (og == obj.group)
            if obj.index >= 0:
                bind = bind & (oi == obj.index)
        else:
            bind = in_subj

        def eval_node(node):
            if node.op == OP_AND:
                return eval_node(node.inputs[0]) & eval_node(node.inputs[1])
            if node.op == OP_OR:
                return eval_node(node.inputs[0]) | eval_node(node.inputs[1])
            if node.op == OP_NOT:
                return ~eval_node(node.inputs[0])
            if node.op in BINARY_OPS:
                return state.last_op == node.op  # object identity via bind
            if node.op in UNARY_OPS:
                pred = _unary_pred(spec, state, node, g)
                if node.inputs[0] is self.subject:
                    return pred
                # predicate on the inferred object: gather at op_obj
                padded = torch.cat([pred, torch.zeros_like(pred[:, :1])], 1)
                idx = torch.where(state.op_obj >= 0, state.op_obj, A).long()
                return torch.gather(padded, 1, idx)
            raise NotImplementedError("op %d" % node.op)

        mask = bind & eval_node(self.on)
        n_trig = mask.sum(-1)

        for sym, val in zip(self.receivers, self.values):
            if sym is self.subject and not sym.is_all():
                next_reward = next_reward + torch.where(mask, val, 0.0)
            elif obj is not None and sym is obj and not sym.is_all():
                idx = torch.where(mask, state.op_obj, A).long()
                contrib = torch.zeros(
                    (idx.shape[0], A + 1), dtype=next_reward.dtype,
                    device=device).scatter_add_(
                        1, idx, torch.full(idx.shape, float(val),
                                           dtype=next_reward.dtype,
                                           device=device))
                next_reward = next_reward + contrib[:, :A]
            elif sym.is_all():
                group_reward = group_reward.clone()
                group_reward[:, sym.group] += val * n_trig
            else:
                raise NotImplementedError("receiver symbol not involved in event")

        return next_reward, group_reward, n_trig > 0


class PairSharedObjectRule(_BaseRule):
    """AND of two binary events whose subjects both infer the same object
    (the cooperative double_attack pattern;
    ``magent_tpu/core/rules.py:182-244``)."""

    def __init__(self, spec, op1, op2, sub1, sub2, obj, receivers, values,
                 is_terminal):
        super().__init__(receivers, values, is_terminal)
        self.op1, self.op2 = op1, op2
        self.sub1, self.sub2 = sub1, sub2
        self.obj = obj

    def _subject_mask(self, spec, state, sym, op):
        A = spec.n_agents_cap
        g = self._gof(spec, state.x.device)
        m = (g == sym.group) & state.active & (state.last_op == op)
        oo = state.op_obj
        ok = oo >= 0
        og_raw, oi = _group_slot_of(spec, oo.clamp(0, A - 1))
        og = torch.where(ok, og_raw, -1)
        m = m & ok & (og == self.obj.group)
        if self.obj.index >= 0:
            m = m & (oi == self.obj.index)
        return m

    def apply(self, spec, state, next_reward, group_reward):
        """-> (next_reward [B, A], group_reward [B, G], triggered [B])."""
        A = spec.n_agents_cap
        m1 = self._subject_mask(spec, state, self.sub1, self.op1)
        same = (self.sub1.group == self.sub2.group) and (self.op1 == self.op2)
        m2 = m1 if same else self._subject_mask(spec, state, self.sub2,
                                                self.op2)

        def degree(m):
            idx = torch.where(m, state.op_obj, A).long()
            return torch.zeros((idx.shape[0], A + 1), dtype=torch.float32,
                               device=idx.device).scatter_add_(
                1, idx, torch.ones(idx.shape, dtype=torch.float32,
                                   device=idx.device))[:, :A]

        k1 = degree(m1)
        k2 = k1 if same else degree(m2)

        oc = state.op_obj.clamp(0, A - 1).long()
        if same:
            # ordered pairs (a, b), a != b within the same group: receivers
            # sub1 and sub2 each take pairs_as_1, as the reference's DFS
            # over ordered pairs pays them
            pairs_as_1 = torch.where(m1, torch.gather(k1, 1, oc) - 1.0, 0.0)
            pairs_as_2 = pairs_as_1
        else:
            pairs_as_1 = torch.where(m1, torch.gather(k2, 1, oc), 0.0)
            pairs_as_2 = torch.where(m2, torch.gather(k1, 1, oc), 0.0)
        total_pairs = pairs_as_1.sum(-1)

        for sym, val in zip(self.receivers, self.values):
            if sym is self.sub1:
                next_reward = next_reward + val * pairs_as_1
            elif sym is self.sub2:
                next_reward = next_reward + val * pairs_as_2
            elif sym is self.obj:
                # per_obj is indexed by object slot directly
                per_obj = k1 * (k1 - 1.0) if same else k1 * k2
                next_reward = next_reward + torch.where(
                    state.active, val * per_obj, 0.0)
            elif sym.is_all():
                group_reward = group_reward.clone()
                group_reward[:, sym.group] += val * total_pairs
            else:
                raise NotImplementedError("receiver not involved in pair rule")

        return next_reward, group_reward, total_pairs > 0


def _symbol_order(reward_rules):
    """Reference symbol numbering: first-visit order over all rules'
    event trees then receivers (reference:
    python/magent/gridworld.py:_serialize_event_exp; the C++ side's
    ``related_symbols`` std::set then iterates in that number order because
    symbol pointers live in one contiguous vector)."""
    order: list[AgentSymbol] = []

    def visit(node):
        for item in node.inputs:
            if isinstance(item, EventNode):
                visit(item)
            elif isinstance(item, AgentSymbol):
                if item not in order:
                    order.append(item)

    for on, receivers, _values, _terminal in reward_rules:
        visit(on)
        for r in receivers:
            if r not in order:
                order.append(r)
    return order


def _related_and_infer(node, sym_index):
    """(related symbols sorted by registration number, infer map sub->obj)
    — reference: RewardEngine.cc collect_related_symbol (:71-100)."""
    related = set()
    infer: dict[AgentSymbol, AgentSymbol] = {}

    def walk(n):
        if n.op in (OP_AND, OP_OR):
            walk(n.inputs[0])
            walk(n.inputs[1])
        elif n.op == OP_NOT:
            walk(n.inputs[0])
        elif n.op in BINARY_OPS:
            related.add(n.inputs[0])
            related.add(n.inputs[1])
            infer.setdefault(n.inputs[0], n.inputs[1])  # std::map keeps first
        else:
            related.add(n.inputs[0])

    walk(node)
    return sorted(related, key=sym_index), infer


class GeneralRule(_BaseRule):
    """Exact vectorized lowering of the reference's binding DFS for an
    arbitrary event AST (``magent_tpu/core/rules.py:294-673``; reference:
    RewardEngine.cc:373-443, :216-371).

    The DFS enumerates *input symbols* in registration order: symbols that
    can infer an object bind it from their ``op_obj`` (re-binding on every
    level, so a shared object's leaf-time value comes from its LAST
    inferring subject), 'any' symbols iterate their group with
    involved-agent exclusivity, and receivers are paid once per triggering
    binding tuple.  Here each 'any' input symbol becomes a dense tensor
    axis behind the env axis B, object bindings become per-axis slot
    expressions, and the AST evaluates to a boolean trigger tensor whose
    reductions give every per-receiver multiplicity.  Joins whose per-env
    tensor would exceed ``MAX_TENSOR`` are evaluated block by block on the
    JAX package's block grid and in its order, so every slot's reward adds
    round as there.

    Reference quirks replicated exactly:

    - a fixed-index input symbol with no inferable object never recurses, so
      the rule never fires (RewardEngine.cc:432-441);
    - an 'all' symbol as an inferred *object* can never bind
      (``bind_with_check`` index test, RewardEngine.cc:14-23);
    - an 'any' subject with an infer pair requires ``op_obj`` non-null even
      when the leaf could be satisfied otherwise (OR branches);
    - binary leaves with an 'all' subject are vacuously true on empty
      groups (RewardEngine.cc:223-234).
    """

    # per-ENV block cap (elements of one env's join block; B envs hold B
    # blocks at once); larger joins are evaluated in chunks
    MAX_TENSOR = 1 << 22

    def __init__(self, spec, on, receivers, values, is_terminal, sym_index):
        super().__init__(receivers, values, is_terminal)
        self.on = on
        related, infer = _related_and_infer(on, sym_index)
        input_symbols, infer_obj = [], []
        added = set()
        # first pass: infer pairs (RewardEngine.cc:163-176)
        for sym in related:
            if sym in added:
                continue
            if sym in infer:
                input_symbols.append(sym)
                infer_obj.append(infer[sym])
                added.add(sym)
                added.add(infer[sym])
        for sym in related:  # second pass: remaining symbols become free
            if sym not in added:
                input_symbols.append(sym)
                infer_obj.append(None)
        self.input_symbols = input_symbols
        self.infer_obj = infer_obj

        self.axes = [s for s in input_symbols if s.is_any()]
        # the block shape: halve the largest axis until one env's block
        # fits MAX_TENSOR
        csz = [spec.groups[s.group].cap for s in self.axes]
        while math.prod(csz) > self.MAX_TENSOR:
            j = max(range(len(csz)), key=lambda i: csz[i])
            csz[j] = (csz[j] + 1) // 2
        self.chunk_sizes = csz

        # the reference asserts binary-leaf objects are never groups
        # (RewardEngine.cc:223); fail at compile instead of at runtime
        leaves: list[EventNode] = []
        _collect_leaves(on, leaves)
        for lf in leaves:
            if lf.op in BINARY_OPS and lf.inputs[1].is_all():
                raise ValueError(
                    "the object of attack/kill/collide cannot be a group "
                    "(reference asserts this)")

        # dead-rule quirks (see class docstring)
        self.never_fires = any(
            (not s.is_any()) and (not s.is_all())
            and (o is None or int(s.index) >= spec.groups[s.group].cap)
            for s, o in zip(input_symbols, infer_obj)
        ) or any(o is not None and o.is_all() for o in infer_obj)

        # leaf-time binding source for each inferred object = LAST inferrer
        self.last_inferrer: dict[AgentSymbol, AgentSymbol] = {}
        for s, o in zip(input_symbols, infer_obj):
            if o is not None:
                self.last_inferrer[o] = s

        for sym in receivers:
            bound = (sym in self.axes or sym.is_all()
                     or sym in self.last_inferrer
                     or (sym in input_symbols and not sym.is_any()))
            if not bound:
                raise NotImplementedError(
                    "receiver symbol not involved in the triggering event")

    def blocks(self, spec):
        """The block grid: each block's start within its axis' group, in
        the JAX package's order (``meshgrid(..., indexing="ij")``, the last
        axis fastest)."""
        caps = [spec.groups[s.group].cap for s in self.axes]
        return list(itertools.product(*[
            range(0, cap, size) for cap, size in zip(caps, self.chunk_sizes)]))

    # ------------------------------------------------------------ evaluation
    def apply(self, spec, state, next_reward, group_reward):
        """-> (next_reward [B, A], group_reward [B, G], triggered [B])."""
        A = spec.n_agents_cap
        B = state.x.shape[0]
        device = state.x.device
        if self.never_fires:
            return next_reward, group_reward, torch.zeros(
                B, dtype=torch.bool, device=device)

        axes = self.axes
        caps = [spec.groups[s.group].cap for s in axes]
        shape = tuple(self.chunk_sizes)  # one env's block shape
        offs = [spec.groups[s.group].offset for s in axes]
        gof = self._gof(spec, device)

        def members_of(group):
            return (gof == group) & state.active

        def first_member_slot(group):
            """Slot of groups[g].get_agents()[0] (first active slot) and
            whether the group has one, per env -> ([B], [B])."""
            off, cap = _group_slice(spec, group)
            act = state.active[:, off:off + cap]
            return off + act.to(torch.int32).argmax(-1), act.any(-1)

        def binding_global(sym):
            """Slot value ``[B]`` (or ``[1]``) of a block-independent bound
            symbol (inferred by a non-'any' symbol, or a fixed input
            symbol)."""
            t = self.last_inferrer.get(sym)
            if t is not None:
                if t.is_all():
                    first, _ = first_member_slot(t.group)
                    return _gather_rows(state.op_obj, first)
                toff, _ = _group_slice(spec, t.group)
                return state.op_obj[:, toff + int(t.index)]
            soff, _ = _group_slice(spec, sym.group)
            return torch.tensor([soff + int(sym.index)], dtype=torch.int32,
                                device=device)

        # ---- per-slot unary predicates, shared by leaves
        def unary_vec(leaf):
            if leaf.op == OP_ALIGN:
                # same-column + same-row group-mate counts of the subject
                # (the reference's counters are dead code; this matches the
                # sequential engine's documented-intent implementation)
                mem = members_of(leaf.inputs[0].group)

                def counts(pos, size):
                    idx = torch.where(mem & (pos >= 0) & (pos < size), pos,
                                      size).long()
                    return torch.zeros((B, size + 1), dtype=torch.int32,
                                       device=device).scatter_add_(
                        1, idx, torch.ones_like(idx, dtype=torch.int32))

                cnt_col = counts(state.x, spec.width)
                cnt_row = counts(state.y, spec.height)
                align = torch.gather(
                    cnt_col, 1, state.x.clamp(0, spec.width - 1).long()) + \
                    torch.gather(cnt_row, 1,
                                 state.y.clamp(0, spec.height - 1).long())
                return align > 1
            return _unary_pred(spec, state, leaf, gof)

        def eval_block(starts, next_reward):
            """Evaluate one join block (axis i covers group slots
            ``starts[i] .. starts[i]+shape[i]`` within its group) for every
            env and pay the block-local receivers ('any' axes and objects
            inferred by an 'any' axis).  Returns (next_reward, block
            trigger count [B])."""

            def bcast(vec, axis):
                """Lift a per-axis vector ``[B or 1, n]`` (or a per-env
                scalar ``[B or 1]`` for axis None) onto the block tensor
                ``[B, *shape]`` by broadcasting."""
                view = [vec.shape[0]] + [1] * len(shape)
                if axis is not None:
                    view[1 + axis] = shape[axis]
                return vec.reshape(view)

            def axis_slots(i):
                return (offs[i] + starts[i] + torch.arange(
                    shape[i], dtype=torch.int32, device=device))[None]

            def axis_valid(i):
                return (starts[i] + torch.arange(shape[i], device=device)
                        < caps[i])[None]

            def axis_take(per_slot, i):
                """Block slice ``per_slot[:, lo:lo + shape[i]]`` (``lo =
                offs[i] + starts[i]``), zero-padded past the last slot as
                the JAX package pads before its ``dynamic_slice`` (a ragged
                tail of the last group); pad reads are masked by
                axis_valid through T."""
                lo = offs[i] + starts[i]
                if lo + shape[i] > A:
                    per_slot = torch.cat([per_slot, per_slot.new_zeros(
                        (per_slot.shape[0], shape[i]))], 1)
                return per_slot[:, lo:lo + shape[i]]

            def binding(sym):
                """(axis_or_None, slot values) for a bound (non-'all')
                symbol."""
                if sym in axes:
                    i = axes.index(sym)
                    return i, axis_slots(i)
                t = self.last_inferrer.get(sym)
                if t is not None and t.is_any():
                    i = axes.index(t)
                    return i, axis_take(state.op_obj, i)
                return None, binding_global(sym)

            def take(per_slot, sym):
                """Gather a per-slot tensor at a symbol's bound slots."""
                i, slots = binding(sym)
                return bcast(_gather_rows(per_slot, slots.clamp(0, A - 1)), i)

            def eval_node(node):
                if node.op in (OP_AND, OP_OR):
                    a, b = (eval_node(x) for x in node.inputs)
                    return a & b if node.op == OP_AND else a | b
                if node.op == OP_NOT:
                    return ~eval_node(node.inputs[0])
                if node.op in BINARY_OPS:
                    sub, obj = node.inputs[0], node.inputs[1]
                    oi, ovals = binding(obj)
                    obj_t = bcast(ovals, oi)
                    if sub.is_all():
                        # forall members: last_op==op and op_obj==obj
                        mem = members_of(sub.group)
                        n_mem = mem.sum(-1, dtype=torch.int32)
                        hit = mem & (state.last_op == node.op)
                        idx = torch.where(hit & (state.op_obj >= 0),
                                          state.op_obj, A).long()
                        cnt_at = torch.zeros(
                            (B, A + 1), dtype=torch.int32,
                            device=device).scatter_add_(
                            1, idx, torch.ones_like(idx, dtype=torch.int32))
                        cnt_at[:, A] = 0  # the padded entry reads 0
                        safe = torch.where((obj_t >= 0) & (obj_t < A),
                                           obj_t, A)
                        # vacuously True on an empty group
                        return _gather_rows(cnt_at, safe) == bcast(n_mem, None)
                    sub_op = take(state.last_op, sub) == node.op
                    sub_obj = take(state.op_obj, sub)
                    return sub_op & (sub_obj == obj_t)
                # unary leaf
                sym = node.inputs[0]
                if node.op == OP_IN_A_LINE:
                    off = _group_slice(spec, sym.group)[0]
                    pred = _unary_pred(spec, state, node, gof)
                    return bcast(pred[:, off], None)
                if sym.is_all():  # forall members (vacuous True when empty)
                    mem = members_of(sym.group)
                    return bcast((~mem | unary_vec(node)).all(-1), None)
                return take(unary_vec(node), sym)

            T = eval_node(self.on).expand((B,) + shape)
            for i in range(len(axes)):  # mask ragged block tails
                T = T & bcast(axis_valid(i), i)

            # ---- binding masks (DFS-level pruning, applied to every branch)
            def bind_mask(sub, obj):
                """op_obj of `sub` binds `obj`: non-null + group/index check
                (bind_with_check, RewardEngine.cc:14-23)."""
                if sub.is_any():
                    i = axes.index(sub)
                    oo = axis_take(state.op_obj, i)
                    ax = i
                elif sub.is_all():
                    first, nonempty = first_member_slot(sub.group)
                    oo = _gather_rows(state.op_obj, first)
                    ax = None
                else:
                    soff, _ = _group_slice(spec, sub.group)
                    oo = state.op_obj[:, soff + int(sub.index)]
                    ax = None
                ok = oo >= 0
                og, oidx = _group_slot_of(spec, oo.clamp(0, A - 1))
                ok = ok & (og == obj.group)
                if obj.index >= 0:
                    ok = ok & (oidx == obj.index)
                if sub.is_all():
                    ok = ok & nonempty
                return bcast(ok, ax)

            for sub, obj in zip(self.input_symbols, self.infer_obj):
                if obj is not None:
                    T = T & bind_mask(sub, obj)
                if sub.is_any():
                    i = axes.index(sub)
                    T = T & bcast(axis_take(state.active, i), i)
                elif not sub.is_all():  # fixed: index must be within group
                    _, cap = _group_slice(spec, sub.group)
                    k = int(sub.index)
                    n_g = members_of(sub.group).sum(-1)
                    T = T & bcast((k < n_g) & (k < cap), None)

            # involved-agent exclusivity between same-group 'any' axes
            for i in range(len(axes)):
                for j in range(i + 1, len(axes)):
                    if axes[i].group == axes[j].group:
                        T = T & (bcast(axis_slots(i), i)
                                 != bcast(axis_slots(j), j))

            Tf = T.to(torch.float32)
            n_trig = Tf.sum(tuple(range(1, Tf.ndim))) if axes else Tf

            def axis_multiplicity(i):
                other = tuple(1 + k for k in range(len(axes)) if k != i)
                return Tf.sum(other) if other else Tf

            # block-local receivers: per-slot multiplicities live here
            for sym, val in zip(self.receivers, self.values):
                if sym in axes:
                    i = axes.index(sym)
                    m = axis_multiplicity(i)
                    lo = offs[i] + starts[i]
                    n = min(shape[i], caps[i] - starts[i])
                    next_reward = next_reward.clone()
                    next_reward[:, lo:lo + n] += val * m[:, :n]
                elif (sym in self.last_inferrer
                      and self.last_inferrer[sym].is_any()):
                    i = axes.index(self.last_inferrer[sym])
                    m = axis_multiplicity(i)
                    oo = axis_take(state.op_obj, i)
                    next_reward = _add_at(
                        next_reward, torch.where(m > 0, oo.clamp(0, A - 1), A),
                        val * m)
            return next_reward, n_trig

        n_trig = torch.zeros(B, dtype=torch.float32, device=device)
        for starts in self.blocks(spec):
            next_reward, nt = eval_block(starts, next_reward)
            n_trig = n_trig + nt

        # ---- block-independent receivers (need the TOTAL trigger count)
        for sym, val in zip(self.receivers, self.values):
            if sym.is_all():
                group_reward = group_reward.clone()
                group_reward[:, sym.group] += val * n_trig
            elif sym in axes or (sym in self.last_inferrer
                                 and self.last_inferrer[sym].is_any()):
                pass  # paid per block above
            elif sym in self.last_inferrer:
                v = binding_global(sym).expand(B)
                next_reward = _add_at(
                    next_reward,
                    torch.where(n_trig > 0, v.clamp(0, A - 1), A)[:, None],
                    (val * n_trig)[:, None])
            else:  # fixed input symbol bound to its own slot
                soff, _ = _group_slice(spec, sym.group)
                next_reward = next_reward.clone()
                next_reward[:, soff + int(sym.index)] += val * n_trig

        return next_reward, group_reward, n_trig > 0


def compile_rules(spec):
    """Compile every config reward rule into a vectorized plan; symbols are
    numbered over all rules (the reference's registration order), which
    fixes :class:`GeneralRule`'s binding order."""
    order = _symbol_order(spec.reward_rules)
    return [_compile_one(spec, on, receivers, values, terminal, order.index)
            for on, receivers, values, terminal in spec.reward_rules]


def _compile_one(spec, on, receivers, values, terminal, sym_index):
    """The JAX package's routing (``magent_tpu/core/rules.py:687-767``),
    kept exactly so a rule never lands on a different plan than there."""
    symbols: list[AgentSymbol] = []
    _collect_symbols(on, symbols)
    leaves: list[EventNode] = []
    _collect_leaves(on, leaves)

    binary = [lf for lf in leaves if lf.op in BINARY_OPS]
    subjects = []
    objects = []
    for lf in binary:
        if lf.inputs[0] not in subjects:
            subjects.append(lf.inputs[0])
        if lf.inputs[1] not in objects:
            objects.append(lf.inputs[1])

    # pair pattern: two distinct 'any' subjects, one shared 'any' object,
    # AND root — the cooperative double_attack shape, lowered to degree
    # counting instead of a dense pair join
    if (
        len(binary) == 2
        and len(subjects) == 2
        and len(objects) == 1
        and on.op == OP_AND
        and len(leaves) == 2
        and subjects[0].is_any()
        and subjects[1].is_any()
        and objects[0].is_any()
        and objects[0] not in subjects
        and all(r in subjects or r is objects[0] or r.is_all()
                for r in receivers)
    ):
        return PairSharedObjectRule(
            spec, binary[0].op, binary[1].op,
            binary[0].inputs[0], binary[1].inputs[0], objects[0],
            receivers, values, terminal,
        )

    # single-subject pattern (with optional inferred object): per-slot masks
    if len(symbols) <= 2 and len(subjects) <= 1 and len(objects) <= 1:
        ok_unary = all(
            lf.inputs[0] is (subjects[0] if subjects else symbols[0])
            or (binary and lf.inputs[0] is objects[0])
            for lf in leaves if lf.op in UNARY_OPS
        )
        no_align = all(lf.op != OP_ALIGN for lf in leaves)
        if binary:
            subject = subjects[0]
            obj = objects[0]
            shape_ok = (obj not in subjects and len(symbols) == 2
                        and not obj.is_all())
        else:
            subject = symbols[0]
            obj = None
            shape_ok = len(symbols) == 1
        # a receiver must be bound by the event (subject/object) or be a
        # whole group; a fixed-index receiver outside the event goes to
        # GeneralRule, which rejects it at compile time
        recv_ok = all(
            r is subject or (obj is not None and r is obj) or r.is_all()
            for r in receivers
        )
        # 'all' subjects need group-level logic evaluation: the general join
        if shape_ok and ok_unary and no_align and recv_ok \
                and subject.is_any():
            return SingleSubjectRule(
                spec, on, subject, obj, receivers, values, terminal)

    # everything else: the exact general join
    return GeneralRule(spec, on, receivers, values, terminal, sym_index)
