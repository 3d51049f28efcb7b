"""One env step as batched tensor ops (port of ``magent_tpu/core/engine.py``
``make_step`` and ``make_clear_dead``).

A step takes one of two paths, chosen once in :func:`make_step`:

- the **gridless** path (``maintain_grid=False``, :class:`VecGridWorld`,
  specs without food, turn mode or absorb, within the pair kernels' cap):
  every occupancy question is answered pairwise by the kernels of
  :mod:`magent_tpu_torch.ops.attack_prefix` — cell equality for 1x1
  bodies, rect containment and first rect overlap for multi-cell bodies
  (pursuit's 2x2 predators); ``state.cell_slot`` is neither read nor
  rebuilt; border walls are answered by formula, interior walls by one
  gather of a packed per-body-size overlap grid.  One multi-cell world of
  ``QUAD_MAX_SINGLE`` to ``SEG_DEFAULT_MAX`` slots sorts its agents by y
  once per step and takes the y-segmented forms of the rect and rank
  sweeps;
- the **grid** path (the stateful ``GridWorld``, every spec past the
  gridless caps, food, turn mode and absorb): attack targets and move
  blocking are read from ``state.cell_slot``, ``state.cell_wall`` (any
  walls) and ``state.cell_food``; dead bodies are cleared from the grid,
  and after the move 1x1 grids are rebuilt while multi-cell bodies are
  cleared and refilled rect by rect.  Damage goes through
  ``rank_prefix`` (hp form) up to the quad cap and a sort above it; 1x1
  move claims through ``move_claims`` or a sort, multi-cell claims (and
  turns) through a scatter-min over a claim grid.  Food (corpse drops,
  eating by attack), turn mode (bodies rotating into their new facing's
  rect, claimed as moves are) and absorb (``can_absorb`` goals) run on
  this path only.

Phases run in the reference order (reference:
src/gridworld/GridWorld.cc:456-631)::

    attack -> starve -> turn (turn mode) -> move -> reward rules -> done

Attacks execute in a random priority order (a SplitMix mix of a fresh
threefry subkey and the slot).  Every tensor carries the env axis B written
out; one kernel launch serves the batch.  No state tensor is updated in
place: callers may keep references to an earlier state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import random as rnd
from .. import spec as speclib
from ..ops import attack_prefix as ap
from ..spec import NORTH, OP_ATTACK, OP_COLLIDE, OP_KILL, OP_NULL
from . import geometry as geo
from .state import State

_SLOT_TABLES = (
    "attack_base", "n_action", "att_dx", "att_dy", "width", "length",
    "att_x_offset", "att_y_offset", "attack_in_group", "attack_penalty",
    "damage", "hp_max", "dead_penalty", "step_recover", "turn_base",
    "move_dx", "move_dy", "eat_ability", "can_absorb",
)


class _Tables:
    """The spec's per-slot tables (``s_*``) as tensors on one device, and
    the gridless step's packed wall grid when the map has interior walls
    (``wall_code`` [H*W] and ``wall_bit`` [A], see :func:`_wall_rect_code`;
    None for border walls only).  ``att_reach_y`` and ``max_dy``, the
    largest |y| reach of an attack and of a move (NORTH frames), bound the
    y-distance of interacting pairs for the segmented sweeps."""

    def __init__(self, spec: speclib.GameSpec, device, wall_ctx=None):
        for name in _SLOT_TABLES:
            setattr(self, name,
                    torch.as_tensor(getattr(spec, "s_" + name), device=device))
        A = spec.n_agents_cap
        self.att_reach_y = int(np.max(np.abs(
            spec.s_att_y_offset[:, None] + spec.s_att_dy))) if A else 0
        self.max_dy = int(np.max(np.abs(spec.s_move_dy))) if A else 0
        self.gof = torch.as_tensor(spec.group_of_slot, device=device)
        self.slots = torch.arange(spec.n_agents_cap, dtype=torch.int32,
                                  device=device)
        # body-cell offsets (i, j) of the max_body^2 scan, i outer and j
        # inner (the order of engine.py:773-782), as [MB*MB, 1, 1]
        offs = np.arange(spec.max_body_w, dtype=np.int32)
        self.body_i = torch.as_tensor(
            np.repeat(offs, spec.max_body_w)[:, None, None], device=device)
        self.body_j = torch.as_tensor(
            np.tile(offs, spec.max_body_w)[:, None, None], device=device)
        self.max_eaters = _max_eaters(spec) if spec.food_mode else 0
        self.wall_code = self.wall_bit = None
        if wall_ctx is not None:
            code, bit = wall_ctx
            self.wall_code = torch.as_tensor(code.reshape(-1), device=device)
            self.wall_bit = torch.as_tensor(bit, device=device)


def _max_eaters(spec: speclib.GameSpec) -> int:
    """The most agents that can attack one cell in a step: live bodies are
    disjoint, so their anchors differ, and an anchor that reaches a cell
    lies at one of the (type, direction, attack) offsets from it.  Bounds
    the eaters of one food cell (:func:`_sum_in_order`)."""
    offsets = set()
    for g in spec.groups:
        t = g.type
        n = t.attack_range.count
        for d in range(4):
            dirs = torch.full((n,), d, dtype=torch.int32)
            zero = torch.zeros_like(dirs)
            rx, ry = geo.save_to_real(zero, zero, dirs, t.width, t.length)
            tx, ty = geo.rela_to_abs(
                rx, ry, dirs,
                t.att_x_offset + torch.as_tensor(t.attack_range.dx[:n]),
                t.att_y_offset + torch.as_tensor(t.attack_range.dy[:n]))
            offsets.update(zip(tx.tolist(), ty.tolist()))
    return max(1, min(len(offsets), spec.n_agents_cap))


def _tables_for(spec: speclib.GameSpec, cache: dict, device,
                wall_ctx=None) -> _Tables:
    device = torch.device(device)
    if device not in cache:
        cache[device] = _Tables(spec, device, wall_ctx)
    return cache[device]


class _Route(NamedTuple):
    """Where a step resolves occupancy, decided once per spec."""
    grid: bool  # read, clear and rebuild state.cell_slot
    quad: bool  # pair kernels; else the sort branches (grid path only)
    seg: bool = False  # y-segmented rect sweeps (one multi-cell world)


# above this many slots a single multi-cell world leaves the y-segmented
# pair sweeps for the grid path (the JAX package's engine.py:155)
SEG_DEFAULT_MAX = 65536


def _seg_win_hint(spec: speclib.GameSpec, A: int, margin: int) -> int:
    """Partner-window width of the segmented sweeps (``engine.py:159-166``):
    the agents within ``margin`` rows of a SEG_ROWS segment at uniform
    density (A / map height), three times over, plus slack; a wider window
    takes the full sweep."""
    per_row = -(-A // max(spec.height, 1))
    return ap.SEG_ROWS + 6 * margin * per_row + 512


def _seg_order(state: State):
    """One stable sort of the single world's y serves every segmented sweep
    of a step (``engine.py:1043-1051``; positions change only in the move
    phase, which runs last) -> (sort_y [A] int32, order [A] int64, order
    [A] int32, {margin: plan} filled by :func:`_seg_kwargs`)."""
    if state.y.shape[0] != 1:
        raise ValueError("the segmented sweeps step one world, got a batch "
                         "of %d" % state.y.shape[0])
    sort_y, order = torch.sort(state.y[0], stable=True)
    return sort_y, order, order.to(torch.int32), {}


def _seg_kwargs(spec: speclib.GameSpec, seg_ctx, margin: int) -> dict:
    """A segmented sweep's window keywords at ``margin``, with the plan
    made once per step for each distinct margin (pursuit's occupant and
    both move sweeps share margin 4)."""
    sort_y, _, _, plans = seg_ctx
    seg_win = _seg_win_hint(spec, spec.n_agents_cap, margin)
    if margin not in plans:
        plans[margin] = ap._seg_plan(sort_y, margin, seg_win)
    return dict(margin=margin, seg_win=seg_win, plan=plans[margin])


def _permute(rows, order):
    """Stack [1, A] operands as int32 rows and permute them to sorted order
    in one gather -> [k, A] (floats ride as their bits)."""
    return torch.stack([r[0].view(torch.int32) if r.dtype == torch.float32
                        else r[0].to(torch.int32) for r in rows])[:, order]


def _unpermute(rows, order):
    """Scatter [k, A] sorted-order int32 rows back to slot order in one
    write -> [k, 1, A]."""
    return torch.empty_like(rows).scatter_(
        1, order.expand(rows.shape), rows)[:, None]


def _gridless_capable(spec: speclib.GameSpec) -> bool:
    """Specs whose occupancy questions the pair kernels answer: no food
    cells, no turn mode, no absorb (``engine.py:199-210``)."""
    return not (spec.food_mode or spec.turn_mode
                or bool(spec.g_can_absorb.any()))


def _wall_rect_code(spec: speclib.GameSpec, wall):
    """Pack per-body-size wall-overlap bitmaps into one int32 grid (host
    numpy, as ``engine.py:114-144``): bit b of ``code[y, x]`` says a body
    rect of the b-th distinct (width, length) anchored at (x, y) overlaps a
    wall cell of the full [H, W] bool map ``wall``; ``s_bit[slot]`` selects
    the slot's bit.  Gridless specs have no turn mode, so every footprint
    is the NORTH (width, length) rect.  -> (code [H, W], s_bit [A])."""
    H, W = spec.height, spec.width
    wall = np.asarray(wall, bool)
    if wall.shape != (H, W):
        raise ValueError("wall map has shape %s, expected %s"
                         % (wall.shape, (H, W)))
    sizes = sorted({(int(w), int(l))
                    for w, l in zip(spec.s_width, spec.s_length)})
    if len(sizes) > 31:
        raise ValueError("%d distinct body sizes exceed the 31 bits of the "
                         "wall code" % len(sizes))
    code = np.zeros((H, W), np.int32)
    for b, (bw, bh) in enumerate(sizes):
        blocked = np.zeros((H, W), bool)
        for i in range(bw):
            for j in range(bh):
                blocked[: H - j, : W - i] |= wall[j:, i:]
        code |= blocked.astype(np.int32) << b
    bit_of = {s: b for b, s in enumerate(sizes)}
    s_bit = np.array([bit_of[(int(w), int(l))]
                      for w, l in zip(spec.s_width, spec.s_length)], np.int32)
    return code, s_bit


def _wall_blocked_gridless(spec, T: _Tables, nx, ny):
    """Does the body rect anchored at (nx, ny) overlap a wall?  Border walls
    only: by formula (x == 0 or y == 0; the far edges are out of bounds).
    Interior walls: one gather of the packed code grid.  Only meaningful
    where the move is in bounds (``engine.py:560-575``)."""
    if T.wall_code is None:
        return (nx == 0) | (ny == 0)
    cx = nx.clamp(0, spec.width - 1)
    cy = ny.clamp(0, spec.height - 1)
    code = T.wall_code[(cy * spec.width + cx).long()]
    return ((code >> T.wall_bit) & 1) != 0


def _row_lookup(table, idx):
    """``table[slot, idx[b, slot]]`` for a per-slot table [A, K]."""
    B, A = idx.shape
    return torch.gather(table.expand(B, A, table.shape[1]), 2,
                        idx.long()[..., None])[..., 0]


def attack_rank(state: State, A: int):
    """Split the env keys and mix the fresh subkey with the slot index into
    uint32 attack priorities (engine.py:1032-1038) -> (next key, rank)."""
    keys = rnd.split(state.key)  # [B, 2, 2]
    slot = torch.arange(A, dtype=torch.int64, device=state.key.device)
    z = (keys[:, 1, :1] + rnd.mul32(slot, 0x9E3779B9)) & rnd.MASK32
    return keys[:, 0], rnd.splitmix_finalize(z)


def _grid_at(grid, cell):
    """``grid[b, cell[b, a] // W, cell[b, a] % W]`` for a [B, H, W] grid and
    flat in-map cells [B, A]."""
    B = grid.shape[0]
    return torch.gather(grid.reshape(B, -1), 1, cell.long())


def _set_bodies(cell_slot, mask, x, y, T, dirs, values):
    """Write ``values`` (-1, or the slots [A]) into every cell of the masked
    slots' body rects in one scatter over the max_body^2 offsets; the rest
    write a dump cell past the end (``engine.py:66-88`` ``_clear_body`` and
    ``_fill_body``, ``mode="drop"``).  Live bodies are disjoint, so no two
    masked cells collide."""
    B, H, W = cell_slot.shape
    if T.body_i.shape[0] == 1:  # 1x1 bodies: the anchor cell alone
        idx = torch.where(mask, y * W + x, H * W).long()
    else:
        bw, bh = geo.size_for_dir(dirs, T.width, T.length)
        ok = mask & (T.body_i < bw) & (T.body_j < bh)  # [MB*MB, B, A]
        idx = torch.where(ok, (y + T.body_j) * W + x + T.body_i, H * W)
        idx = idx.permute(1, 0, 2).reshape(B, -1).long()
    flat = torch.cat([cell_slot.reshape(B, H * W),
                      cell_slot.new_full((B, 1), -1)], 1)
    if isinstance(values, int):
        flat = flat.scatter(1, idx, values)
    else:
        flat = flat.scatter(1, idx, values.expand(B, -1).repeat(
            1, T.body_i.shape[0]))
    return flat[:, :H * W].reshape(B, H, W)


def _pad_gather(table, idx, fill):
    """``table[b, idx[b, a]]`` with -1 (or out of range) -> ``fill``
    (``engine.py:42-46``)."""
    n = table.shape[-1]
    ok = (idx >= 0) & (idx < n)
    got = torch.gather(table.expand(idx.shape[0], n), 1,
                       idx.clamp(0, n - 1).long())
    return torch.where(ok, got, fill)


def _segment_starts(sorted_keys):
    first = torch.ones_like(sorted_keys[:, :1], dtype=torch.bool)
    return torch.cat([first, sorted_keys[:, 1:] != sorted_keys[:, :-1]], 1)


def _segment_cumsum(values, seg_start, cumsum=None):
    """Per-segment inclusive cumulative sum over sorted segments; values
    >= 0, so segment bases forward-fill with a cummax (engine.py:54-63).
    ``cumsum``: the running sum along the last axis (``torch.cumsum``'s by
    default)."""
    cum = torch.cumsum(values, -1) if cumsum is None else cumsum(values)
    base = torch.where(seg_start, cum - values, float("-inf"))
    return cum - torch.cummax(base, -1).values


# the block of XLA's cumulative sum on the CPU: each run of 16 summed in
# order, the runs' totals summed the same way, recursively, and each run's
# exclusive prefix added last
_XLA_SCAN_BLOCK = 16


def _cumsum_xla(values):
    """Inclusive f32 cumulative sum of [B, N] along the last axis, rounded
    as the JAX package's ``jnp.cumsum`` rounds on the CPU (XLA's blocked
    scan, above), by elementwise adds alone: the same bits on the CPU and
    the GPU.  ``torch.cumsum`` accumulates f32 in double on the CPU and by
    a parallel scan on the GPU, so it rounds differently from both."""
    B, N = values.shape
    blk = _XLA_SCAN_BLOCK
    m = -(-N // blk)
    rows = torch.nn.functional.pad(values, (0, m * blk - N)).reshape(B, m, blk)
    cols = [rows[..., 0]]
    for k in range(1, blk):
        cols.append(cols[-1] + rows[..., k])
    inner = torch.stack(cols, -1)
    if m > 1:
        pre = _cumsum_xla(inner[..., -1])
        inner = inner + torch.cat([torch.zeros_like(pre[:, :1]),
                                   pre[:, :-1]], 1)[..., None]
    return inner.reshape(B, m * blk)[:, :N]


def _sum_in_order(values, seg_start, k_max):
    """Each segment's total, adding its rows in order from 0 as XLA's
    scatter-add adds duplicate indices on the CPU, by elementwise adds (the
    same bits on the GPU, where ``scatter_add_`` adds in any order) -> [B,
    N], the total on each segment's first row.  No segment may exceed
    ``k_max`` rows."""
    B, N = values.shape
    pos = torch.arange(N, device=values.device)
    head = torch.cummax(torch.where(seg_start, pos, 0), -1).values
    mat = torch.zeros((B, N * k_max + 1), dtype=values.dtype,
                      device=values.device).scatter(
        1, torch.where(pos - head < k_max, head * k_max + pos - head,
                       N * k_max), values)[:, :N * k_max].reshape(B, N, k_max)
    total = mat[..., 0] + 0.0  # 0 + a, as from zeros: -0 becomes +0
    for k in range(1, k_max):
        total = total + mat[..., k]
    return total


def _unsort(values, order):
    """Scatter per-row values in sorted order back to slot order."""
    return torch.empty_like(values).scatter(1, order, values)


def _damage_pairwise(state, tgt_key, valid, P, dmg_slot, hp_t, kr_t, ks_t):
    """Quad branch (engine.py:339-388): with P the damage earlier-ranked
    attackers deal to my target, every attacker-side quantity is
    elementwise and the damage per target is ONE scatter-max."""
    B, A = tgt_key.shape
    cum = P + dmg_slot
    not_yet_dead = hp_t - P >= 0.0  # target still alive when I strike
    acted = valid & not_yet_dead
    is_killer = acted & (hp_t - cum < 0.0)  # be_attack: hp < 0 (GridWorld.h:203-208)

    dmg_t = torch.zeros((B, A + 1), dtype=state.hp.dtype,
                        device=tgt_key.device).scatter_reduce(
        1, torch.where(acted, tgt_key, A).long(),
        torch.where(acted, cum, 0.0), "amax")[:, :A]
    hp = state.hp - dmg_t
    died = (dmg_t > 0.0) & (hp < 0.0) & state.active & ~state.dead
    op_new = torch.where(is_killer, OP_KILL,
                         torch.where(acted, OP_ATTACK, OP_NULL)).to(torch.int32)
    obj_new = torch.where(acted, tgt_key, -1)
    return (hp, died, op_new, obj_new, torch.where(is_killer, kr_t, 0.0),
            torch.where(is_killer, ks_t, 0.0))


def _damage_sorted(state, rank, tgt_key, tgt_c, valid, dmg_slot, kr_t, ks_t):
    """Sort branch (engine.py:389-448): attackers sorted by (target, raw
    priority) in one int64 key, segmented cumulative damage per target.
    The stable sort breaks exact priority ties by slot.  Sums of battle's
    damages are exact in any order; general damages may differ from the
    JAX package's scan order in the last bits."""
    B, A = tgt_key.shape
    hp_t = torch.where(valid, torch.gather(state.hp, 1, tgt_c.long()),
                       float("inf"))
    key = (tgt_key.to(torch.int64) << 32) | rank
    order = torch.sort(key, dim=-1, stable=True).indices

    def take(t):
        return torch.gather(t, 1, order)

    s_tgt, s_dmg, s_hp, s_valid = (take(t) for t in (tgt_key, dmg_slot, hp_t,
                                                    valid))
    seg_start = _segment_starts(s_tgt)
    s_cum = _segment_cumsum(s_dmg, seg_start)
    kill_here = s_valid & (s_hp - s_cum < 0.0)  # be_attack: hp < 0 (GridWorld.h:203-208)
    prev_kill = torch.cat([torch.zeros_like(kill_here[:, :1]),
                           kill_here[:, :-1]], 1) & ~seg_start
    is_killer = kill_here & ~prev_kill
    acted = s_valid & ~(kill_here & ~is_killer)  # attacks after the kill are no-ops

    # per-target effects: each segment's last row holds the totals
    applied = torch.where(acted, s_dmg, 0.0)
    totals = torch.stack([_segment_cumsum(applied, seg_start),
                          _segment_cumsum(is_killer.to(s_dmg.dtype),
                                          seg_start)], -1)
    seg_end = torch.cat([seg_start[:, 1:], torch.ones_like(seg_start[:, :1])],
                        1)
    dst = torch.where(seg_end, s_tgt, A).long()[..., None].expand(B, A, 2)
    tgt_fx = torch.zeros((B, A + 1, 2), dtype=s_dmg.dtype,
                         device=key.device).scatter(1, dst, totals)[:, :A]
    hp = state.hp - tgt_fx[..., 0]
    died = (tgt_fx[..., 1] > 0) & state.active & ~state.dead

    op_new = torch.where(is_killer, OP_KILL,
                         torch.where(acted, OP_ATTACK, OP_NULL)).to(torch.int32)
    return (hp, died, _unsort(op_new, order),
            _unsort(torch.where(acted, s_tgt, -1), order),
            _unsort(torch.where(is_killer, take(kr_t), 0.0), order),
            _unsort(torch.where(is_killer, take(ks_t), 0.0), order))


def _attack_phase(spec, T, state: State, rank, route: _Route, seg_ctx=None):
    """Attack resolution (engine.py:212-526; reference GridWorld.cc:470-517,
    Map.cc:209-310).  ``seg_ctx``: :func:`_seg_order`'s sort on the
    segmented route."""
    A = spec.n_agents_cap
    H, W = spec.height, spec.width
    act = state.last_action
    alive = state.active & ~state.dead

    is_attack = alive & (act >= T.attack_base) & (act < T.n_action)
    att_idx = (act - T.attack_base).clamp(0, spec.max_attack - 1)
    adx = _row_lookup(T.att_dx, att_idx)
    ady = _row_lookup(T.att_dy, att_idx)
    rx, ry = geo.save_to_real(state.x, state.y, state.dir, T.width, T.length)
    tx, ty = geo.rela_to_abs(rx, ry, state.dir, T.att_x_offset + adx,
                             T.att_y_offset + ady)
    in_board = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H)
    txc = tx.clamp(0, W - 1)
    tyc = ty.clamp(0, H - 1)
    hit = is_attack & in_board

    if route.grid:
        # the attacked cell's occupant from the grid (engine.py:295)
        tgt = torch.where(hit, _grid_at(state.cell_slot, tyc * W + txc), -1)
    elif route.seg:
        # rect containment, y-segmented (engine.py:259-280): every operand
        # permuted to sorted order in one gather, both results scattered
        # back in one write (hp as its bits)
        sort_y, order, order32, _ = seg_ctx
        bw, bh = geo.size_for_dir(state.dir, T.width, T.length)
        q = _permute((torch.where(hit, txc, ap.RECT_PAD),
                      torch.where(hit, tyc, ap.RECT_PAD), state.x, state.y,
                      torch.where(alive, bw, 0), torch.where(alive, bh, 0),
                      state.hp), order)
        t_s, h_s = ap.occupant_rect_seg(
            *q[:6], q[6].view(torch.float32), sort_y, order32,
            **_seg_kwargs(spec, seg_ctx, T.att_reach_y + spec.max_body_w))
        tgt, hp_bits = _unpermute(torch.stack([t_s, h_s.view(torch.int32)]),
                                  order)
        hp_t_occ = hp_bits.view(torch.float32)
    elif spec.max_body_w > 1:
        # rect containment (engine.py:254-287, unsegmented): the attacked
        # cell against the live agents' static NORTH body rects
        bw, bh = geo.size_for_dir(state.dir, T.width, T.length)
        tgt, hp_t_occ = ap.occupant_rect(
            *(torch.where(hit, v, ap.RECT_PAD).contiguous() for v in (txc, tyc)),
            state.x.contiguous(), state.y.contiguous(),
            *(torch.where(alive, v, 0).contiguous() for v in (bw, bh)),
            state.hp.contiguous())
    else:
        acell = torch.where(hit, tyc * W + txc, ap.QUERY_NONE)
        own_cell = torch.where(alive, state.y * W + state.x, ap.CELL_DEAD)
        tgt, hp_t_occ = ap.occupant(acell.to(torch.int32).contiguous(),
                                    own_cell.to(torch.int32).contiguous(),
                                    state.hp.contiguous())

    # target group from the contiguous per-group slot ranges
    tgt_c = tgt.clamp(0, A - 1)
    tgt_group = torch.zeros_like(tgt)
    for gg in range(1, spec.n_groups):
        tgt_group = tgt_group + (tgt_c >= int(spec.group_offsets[gg])).to(
            torch.int32)
    valid = (tgt >= 0) & (T.attack_in_group | (tgt_group != T.gof))

    # attack penalty for every attacker, hit or miss (GridWorld.cc:488,505)
    next_reward = state.next_reward + torch.where(is_attack, T.attack_penalty,
                                                  0.0)
    tgt_key = torch.where(valid, tgt, A).to(torch.int32)
    dmg_slot = torch.where(valid, T.damage, 0.0)

    def g_table(table):
        out = torch.full(tgt_group.shape, float(table[0]), dtype=torch.float32,
                         device=tgt.device)
        for gg in range(1, spec.n_groups):
            out = torch.where(tgt_group == gg, float(table[gg]), out)
        return out

    kr_t = g_table(spec.g_kill_reward)
    ks_t = g_table(spec.g_kill_supply)

    if route.quad:
        # order-aware damage: P = damage earlier-ranked attackers deal to my
        # target; the grid path's sweep also picks up the target's hp
        rank_key = ap.pack_rank(rank, A)
        if route.grid:
            P, hp_t = ap.rank_prefix(tgt_key, rank_key, dmg_slot.contiguous(),
                                     state.hp.contiguous())
        elif route.seg:
            # attackers interact only through a shared target, which lies
            # within the attack reach of both (engine.py:347-362)
            sort_y, order, _, _ = seg_ctx
            q = _permute((tgt_key, rank_key, dmg_slot), order)
            P_s = ap.rank_prefix_seg(
                q[0], q[1], q[2].view(torch.float32), sort_y,
                **_seg_kwargs(spec, seg_ctx,
                              2 * (T.att_reach_y + spec.max_body_w)))
            P = _unpermute(P_s.view(torch.int32)[None], order)[0].view(
                torch.float32)
            hp_t = hp_t_occ
        else:
            P = ap.rank_prefix(tgt_key, rank_key, dmg_slot.contiguous())
            hp_t = hp_t_occ
        hp_t = torch.where(valid, hp_t, float("inf"))
        hp, died, op_new, obj_new, kr_gain, supply = _damage_pairwise(
            state, tgt_key, valid, P, dmg_slot, hp_t, kr_t, ks_t)
    else:
        hp, died, op_new, obj_new, kr_gain, supply = _damage_sorted(
            state, rank, tgt_key, tgt_c, valid, dmg_slot, kr_t, ks_t)

    last_op = torch.where(op_new != OP_NULL, op_new, state.last_op)
    op_obj = torch.where(op_new != OP_NULL, obj_new, state.op_obj)
    next_reward = next_reward + kr_gain
    # every kill calls add_hp(kill_supply), which clamps to hp_max
    # (GridWorld.h:185) — gate on the kill, not the sign
    hp = torch.where(op_new == OP_KILL, torch.minimum(T.hp_max, hp + supply),
                     hp)
    # dying targets: reward replaced by dead_penalty (GridWorld.h:203-208)
    next_reward = torch.where(died, T.dead_penalty, next_reward)
    cell_slot, cell_food = state.cell_slot, state.cell_food
    if route.grid:
        cell_slot = _set_bodies(cell_slot, died, state.x, state.y, T,
                                state.dir, -1)
    if spec.food_mode:
        # an attack on a cell with no agent but food (presence is >= 0: a
        # 0-value corpse is still food) eats it (engine.py:296-299)
        food = _grid_at(state.cell_food, tyc * W + txc)
        hp, cell_food = _food_effects(
            T, state, hp, op_new == OP_KILL, g_table(spec.g_food_supply),
            hit & (tgt < 0) & (food >= 0.0), tyc * W + txc, rank)
    return state.replace(hp=hp, dead=state.dead | died,
                         next_reward=next_reward, last_op=last_op,
                         op_obj=op_obj, cell_slot=cell_slot,
                         cell_food=cell_food)


def _food_effects(T, state: State, hp, killer, supply_t, food_target, acell,
                  rank):
    """Food of one attack phase (engine.py:475-516; reference Map.cc:277-303)
    -> (hp, cell_food).  Each killer drops its target group's food_supply
    at the attacked cell (one killer per target: the cells are unique).
    Then the eaters of each food cell, in attack-priority order, each take
    at most its eat_ability of what the earlier ones left; a later eater
    facing less than 0.1 gets nothing, every eater's hp is clamped to its
    maximum, and a cell eaten below 0.1 loses its food.  Each cell's eaten
    total adds the eats in that order, as the JAX package's scatter-add
    does on the CPU, so the GPU keeps the CPU's bits."""
    B, H, W = state.cell_food.shape
    dump = H * W
    flat = torch.cat([state.cell_food.reshape(B, dump),
                      state.cell_food.new_zeros((B, 1))], 1).scatter(
        1, torch.where(killer, acell, dump).long(),
        torch.where(killer, supply_t, 0.0))[:, :dump]

    fcell = torch.where(food_target, acell, dump)
    order = torch.sort((fcell.to(torch.int64) << 32) | rank, dim=-1,
                       stable=True).indices
    f_cell = torch.gather(fcell, 1, order)
    f_ok = torch.gather(food_target, 1, order)
    f_eat = torch.where(f_ok, torch.gather(T.eat_ability.expand(B, -1), 1,
                                           order), 0.0)
    f_start = _segment_starts(f_cell)
    f_cum = _segment_cumsum(f_eat, f_start, _cumsum_xla)
    f_avail = torch.where(f_ok, torch.gather(flat, 1, f_cell.clamp(
        max=dump - 1).long()), 0.0)
    remain = f_avail - (f_cum - f_eat)  # what the earlier eaters left
    amount = torch.where((remain < 0.1) & ~f_start, 0.0,
                         torch.minimum(remain.clamp_min(0.0), f_eat))
    ate = _unsort(f_ok, order)
    # add_hp clamps unconditionally (GridWorld.h:185), even for a 0 eat
    hp = torch.where(ate, torch.minimum(T.hp_max, hp + _unsort(amount, order)),
                     hp)
    # per cell: the total on its first eater's row, written once
    heads = torch.where(f_start & (f_cell < dump), f_cell, dump).long()
    eaten = torch.zeros((B, dump + 1), dtype=flat.dtype,
                        device=flat.device).scatter(
        1, heads, _sum_in_order(amount, f_start, T.max_eaters))[:, :dump]
    was_eaten = torch.zeros((B, dump + 1), dtype=torch.bool,
                            device=flat.device).scatter(
        1, heads, True)[:, :dump]
    flat = flat - eaten
    flat = torch.where((flat < 0.1) & was_eaten, -1.0, flat)
    return hp, flat.reshape(B, H, W)


def _starve_phase(spec, T, state: State, route: _Route):
    """hp recovery / decay (engine.py:529-557; reference GridWorld.cc:519-542,
    Agent::starve GridWorld.h:194-201)."""
    alive = state.active & ~state.dead
    rec = T.step_recover
    hp_pos = torch.minimum(T.hp_max, state.hp + rec)  # add_hp clips at max
    if bool((spec.g_step_recover > 0).all()):
        # no type can starve: pure recovery, no death bookkeeping
        return state.replace(hp=torch.where(alive, hp_pos, state.hp))
    hp_neg = state.hp + rec  # be_attack(-rec): no clip, death below 0
    hp = torch.where(alive, torch.where(rec > 0, hp_pos, hp_neg), state.hp)
    starved = alive & (rec <= 0) & (hp < 0.0)
    next_reward = torch.where(starved, T.dead_penalty, state.next_reward)
    cell_slot = state.cell_slot
    if route.grid:
        cell_slot = _set_bodies(cell_slot, starved, state.x, state.y, T,
                                state.dir, -1)
    return state.replace(hp=hp, dead=state.dead | starved,
                         next_reward=next_reward, cell_slot=cell_slot)


def _claims_sorted(tcell):
    """Sort branch of the move claims (engine.py:793-813): movers sorted by
    (target cell, slot) in one int64 key; the segment head wins its cell
    and every row carries its segment head's slot -> (wins, head)."""
    B, A = tcell.shape
    slots = torch.arange(A, dtype=torch.int64, device=tcell.device)
    order = torch.sort(tcell.to(torch.int64) * A + slots, dim=-1).indices
    seg_start = _segment_starts(torch.gather(tcell, 1, order))
    head_pos = torch.cummax(torch.where(seg_start, slots, 0), -1).values
    head = torch.gather(order, 1, head_pos).to(torch.int32)
    return _unsort(seg_start, order), _unsort(head, order)


def _move_phase_gridless_rect(spec, T, state: State, is_move, in_bounds, nx,
                              ny, bw, bh, alive, seg_ctx=None):
    """Gridless move resolution for multi-cell bodies (engine.py:577-697):
    two pairwise rect sweeps reproduce the grid path's semantics cell for
    cell —

    1. blocking: the current occupant (self excluded) of the first occupied
       target-rect cell in the grid path's (i outer, j inner) scan order;
    2. claims: a blank mover wins iff no lower slot's target rect covers any
       of its cells; a loser collides with the winner of its first lost
       cell, the min-(first overlap cell, slot) lower-slot claimant.

    Blocking resolves before claims: a blocked mover never claims on the
    grid path.  With ``seg_ctx`` (one big world) both sweeps run
    y-segmented in sorted order: one packed permutation in, one packed
    scatter out (engine.py:620-661)."""
    MB = spec.max_body_w
    wall_blocked = _wall_blocked_gridless(spec, T, nx, ny)
    ok = is_move & in_bounds
    # an in-place move always succeeds and claims nothing
    stay = ok & (nx == state.x) & (ny == state.y)
    # wall-blocked movers still query sweep 1: the grid path's cell scan
    # records the first AGENT cell's occupant even when a wall also blocks
    q_ok = ok & ~stay

    def query_rects(mask, rx, ry, rw, rh):
        return tuple(torch.where(mask, v, fill).contiguous() for v, fill in (
            (rx, ap.RECT_PAD), (ry, ap.RECT_PAD), (rw, 0), (rh, 0)))

    if seg_ctx is not None:
        # the y-margin bounds |y_i - y_j| of an interacting pair: bodies
        # overlap within MB rows, every target lies within max|move dy|
        sort_y, order, order32, _ = seg_ctx
        seg = dict(_seg_kwargs(spec, seg_ctx, MB + 2 * T.max_dy),
                   max_body=MB)
        (nx_s, ny_s, bw_s, bh_s, x_s, y_s, qok_s, alive_s,
         wallb_s) = _permute((nx, ny, bw, bh, state.x, state.y, q_ok, alive,
                              wall_blocked), order)
        qok_s, alive_s = qok_s.bool(), alive_s.bool()
        res1 = ap.rect_first_overlap_seg(
            *query_rects(qok_s, nx_s, ny_s, bw_s, bh_s), x_s, y_s,
            *(torch.where(alive_s, v, 0) for v in (bw_s, bh_s)), sort_y,
            order32, gate="exclude_self", **seg)
        blank_s = qok_s & (res1 >= ap.RECT_NONE) & ~wallb_s.bool()
        claims = query_rects(blank_s, nx_s, ny_s, bw_s, bh_s)
        res2 = ap.rect_first_overlap_seg(*claims, *claims, sort_y, order32,
                                         gate="lower_only", **seg)
        occ_slot, head_slot = _unpermute(torch.stack([res1, res2]), order)
    else:
        occ_slot = ap.rect_first_overlap(
            *query_rects(q_ok, nx, ny, bw, bh), state.x.contiguous(),
            state.y.contiguous(),
            *(torch.where(alive, v, 0).contiguous() for v in (bw, bh)),
            max_body=MB, gate="exclude_self")
        blank_pre = q_ok & (occ_slot >= ap.RECT_NONE) & ~wall_blocked
        claims = query_rects(blank_pre, nx, ny, bw, bh)
        head_slot = ap.rect_first_overlap(*claims, *claims, max_body=MB,
                                          gate="lower_only")
    occupied = occ_slot < ap.RECT_NONE
    blank = q_ok & ~occupied & ~wall_blocked
    lost = blank & (head_slot < ap.RECT_NONE)
    wins = blank & ~lost
    success = wins | stay
    coll_obj = torch.where(lost, head_slot,
                           torch.where(occupied, occ_slot, -1))
    collide = is_move & ~success & in_bounds & (coll_obj >= 0)
    return state.replace(
        x=torch.where(success, nx, state.x),
        y=torch.where(success, ny, state.y),
        last_op=torch.where(collide, OP_COLLIDE, state.last_op).to(
            torch.int32),
        op_obj=torch.where(collide, coll_obj, state.op_obj),
    )


def _move_phase(spec, T, state: State, route: _Route, seg_ctx=None):
    """Move resolution (engine.py:699-893; reference GridWorld.cc:573-613,
    Map::do_move Map.cc:313-358): a mover succeeds iff its target rect is
    free of live agents and walls at phase start and no lower slot claims
    any of its cells."""
    H, W = spec.height, spec.width
    B, A = state.x.shape
    act = state.last_action
    alive = state.active & ~state.dead

    is_move = alive & ~state.absorbed & (act >= 0) & (act < T.turn_base)
    midx = act.clamp(0, spec.max_move - 1)
    dx = _row_lookup(T.move_dx, midx)
    dy = _row_lookup(T.move_dy, midx)
    ddx, ddy = geo.rotate_move_delta(state.dir, dx, dy)
    nx = state.x + ddx
    ny = state.y + ddy
    bw, bh = geo.size_for_dir(state.dir, T.width, T.length)
    in_bounds = (nx >= 0) & (ny >= 0) & (nx + bw < W) & (ny + bh < H)  # Map.cc:454-455

    if not route.grid and spec.max_body_w > 1:
        return _move_phase_gridless_rect(spec, T, state, is_move, in_bounds,
                                         nx, ny, bw, bh, alive, seg_ctx)
    if not route.grid:
        # one sweep answers claims and blocking
        wall_blocked = _wall_blocked_gridless(spec, T, nx, ny)
        ok = is_move & in_bounds & ~wall_blocked
        tcell = torch.where(ok, ny * W + nx, ap.QUERY_NONE).to(torch.int32)
        cell = torch.where(alive, state.y * W + state.x, ap.CELL_DEAD).to(
            torch.int32)
        cnt, head, occ = ap.move_resolve(tcell.contiguous(), cell.contiguous())
        # an in-place move always succeeds: its only occupant is the mover,
        # and any other claimant is occupancy-blocked by the stayer
        stay = ok & (nx == state.x) & (ny == state.y)
        occupied = ok & ~stay & (occ >= 0)
        blank = ok & ~stay & ~occupied
        wins = blank & (cnt == 0)
        success = wins | stay
        coll_obj = torch.where(blank & ~wins, head,
                               torch.where(occupied, occ, -1))
        collide = is_move & ~success & in_bounds & (coll_obj >= 0)
        return state.replace(
            x=torch.where(success, nx, state.x),
            y=torch.where(success, ny, state.y),
            last_op=torch.where(collide, OP_COLLIDE, state.last_op).to(
                torch.int32),
            op_obj=torch.where(collide, coll_obj, state.op_obj),
        )

    # the wall- and food-encoded grid answers "blocked?" and "by whom?"
    # (engine.py:764-783; Map::get_collide Map.cc:486-501)
    slots = T.slots
    enc = _move_enc(spec, state)
    if spec.max_body_w == 1:
        e = _grid_at(enc, ny.clamp(0, H - 1) * W + nx.clamp(0, W - 1))
        reach = is_move & in_bounds
        blank = reach & ((e == -1) | (e == slots))
        collide_obj = torch.where(reach & (e >= 0) & (e != slots), e, -1)
        # cell claims: the lowest slot wins (reference buffer order)
        tcell = torch.where(blank, ny * W + nx, H * W).to(torch.int32)
        if route.quad:
            cnt, lose_to = ap.move_claims(tcell.contiguous())
            wins = blank & (cnt == 0)
        else:
            first, lose_to = _claims_sorted(tcell)
            wins = blank & first
    else:
        blank, collide_obj, wins, lose_to = _rect_moves_on_grid(
            spec, T, enc, is_move, in_bounds, nx, ny, bw, bh)
    coll_obj = torch.where(blank & ~wins, lose_to, collide_obj)
    collide = is_move & ~wins & in_bounds & (coll_obj >= 0)

    dead, hp, absorbed = state.dead, state.hp, state.absorbed
    cell_slot = state.cell_slot
    set_op = collide
    if bool(spec.g_can_absorb.any()):
        # can_absorb (engine.py:840-866; Map.cc:340-353): the lowest slot
        # colliding with a not yet absorbed absorber is absorbed into it
        # and dies silently (its body leaves the grid); the absorber's hp
        # doubles; later colliders of an absorbed absorber record nothing
        obj_can = collide & _pad_gather(T.can_absorb[None], coll_obj, False)
        cand = obj_can & ~_pad_gather(absorbed, coll_obj, True)
        winner = torch.full((B, A + 1), A, dtype=torch.int32,
                            device=nx.device).scatter_reduce(
            1, torch.where(cand, coll_obj, A).long(), slots.expand(B, A),
            "amin")
        absorb_win = cand & (torch.gather(winner, 1, coll_obj.clamp(
            0, A - 1).long()) == slots)
        newly = torch.zeros((B, A + 1), dtype=torch.bool,
                            device=nx.device).scatter(
            1, torch.where(absorb_win, coll_obj, A).long(), True)[:, :A]
        absorbed = absorbed | newly
        hp = torch.where(newly, hp * 2.0, hp)
        dead = dead | absorb_win
        if spec.max_body_w > 1:
            cell_slot = _set_bodies(cell_slot, absorb_win, state.x, state.y,
                                    T, state.dir, -1)
        set_op = collide & (~obj_can | absorb_win)

    x = torch.where(wins, nx, state.x)
    y = torch.where(wins, ny, state.y)
    if spec.max_body_w == 1:
        # rebuild the grid from final positions in one scatter
        # (engine.py:874-885); dead and empty slots write a dump cell
        cell = torch.where(state.active & ~dead, y * W + x, H * W).long()
        cell_slot = torch.full((B, H * W + 1), -1, dtype=torch.int32,
                               device=x.device).scatter(
            1, cell, slots.expand(B, A))[:, :H * W].reshape(B, H, W)
    else:
        # the movers' old rects cleared, then their new rects filled
        # (engine.py:886-888)
        cell_slot = _set_bodies(cell_slot, wins, state.x, state.y, T,
                                state.dir, -1)
        cell_slot = _set_bodies(cell_slot, wins, nx, ny, T, state.dir, slots)
    return state.replace(
        x=x, y=y, dead=dead, hp=hp, absorbed=absorbed,
        last_op=torch.where(set_op, OP_COLLIDE, state.last_op).to(
            torch.int32),
        op_obj=torch.where(set_op, coll_obj, state.op_obj),
        cell_slot=cell_slot,
    )


def _first_along(mask, values, fill):
    """``values`` at the first True of ``mask`` along axis 0 (the body
    scan's order), ``fill`` where there is none; [K, B, A] -> [B, A]."""
    k = mask.to(torch.uint8).argmax(0, keepdim=True)
    return torch.where(mask.any(0), torch.gather(values, 0, k)[0], fill)


def _rect_cells(spec, T, x, y, bw, bh):
    """The max_body^2 cells of every rect anchored at (x, y) of size (bw,
    bh), scanned i (width) outer and j inner -> (in_rect [K, B, A], the
    cells clipped into the map as flat indices [B, K*A], the cells clipped
    into the (H+1) x (W+1) claim grid [B, K*A])."""
    H, W = spec.height, spec.width
    in_rect = (T.body_i < bw) & (T.body_j < bh)  # [MB*MB, B, A]
    cx, cy = x + T.body_i, y + T.body_j
    return (in_rect,
            _per_cell(cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)).long(),
            _per_cell(cy.clamp(0, H) * (W + 1) + cx.clamp(0, W)).long())


def _per_cell(t):
    """[K, B, A] -> [B, K*A]."""
    K, B, A = t.shape
    return t.permute(1, 0, 2).reshape(B, K * A)


def _from_cells(t, K):
    """[B, K*A] -> [K, B, A]."""
    B = t.shape[0]
    return t.reshape(B, K, -1).permute(1, 0, 2)


def _claim_rects(spec, T, blank, in_rect, claim_cell):
    """The blank rects' slots go into a (H+1) x (W+1) claim grid by one
    scatter-min (the corner cell past the map takes the rest,
    ``engine.py:814-833`` and ``:947-953``); a rect is won where its slot
    holds every one of its cells -> (wins [B, A], lost [K, B, A] its cells
    held by a lower slot, winner [K, B, A] each cell's lowest claimant)."""
    B, A = blank.shape
    H, W = spec.height, spec.width
    K = in_rect.shape[0]
    ok = blank & in_rect
    dump = H * (W + 1) + W
    claim = torch.full((B, (H + 1) * (W + 1)), A, dtype=torch.int32,
                       device=blank.device).scatter_reduce(
        1, torch.where(_per_cell(ok), claim_cell, dump),
        T.slots.expand(B, A).repeat(1, K), "amin")
    winner = _from_cells(torch.gather(claim, 1, claim_cell), K)
    lost = ok & (winner != T.slots)
    return blank & ~lost.any(0), lost, winner


def _rect_moves_on_grid(spec, T, enc, is_move, in_bounds, nx, ny, bw, bh):
    """Blocking and claims of multi-cell movers on the grid (engine.py:764-783,
    :814-833), all max_body^2 cells of every target rect at once ->
    (blank, collide_obj, wins, lose_to).  A mover is blank where no cell
    of its rect holds a wall, food or another agent; its collider is the
    agent in the first such cell, scanning i (width) outer and j inner.
    The blank movers claim their rects (:func:`_claim_rects`), and a
    loser loses to the winner of its first lost cell."""
    slots = T.slots
    body, cell, claim_cell = _rect_cells(spec, T, nx, ny, bw, bh)
    cell_ok = is_move & body
    e = _from_cells(_grid_at(enc, cell), body.shape[0])
    blank = is_move & in_bounds & ~(cell_ok & (e != -1) & (e != slots)).any(0)
    collide_obj = _first_along(cell_ok & in_bounds & (e >= 0) & (e != slots),
                               e, -1)
    wins, lost, winner = _claim_rects(spec, T, blank, body, claim_cell)
    return blank, collide_obj, wins, _first_along(lost, winner, -1)


def _move_enc(spec, state: State):
    """The wall- and food-encoded grid of a phase's start: -2 a wall, -3
    food (``food_mode``), else the occupant's slot or -1 (engine.py:764-766,
    :935-937; Map::get_collide Map.cc:486-501)."""
    enc = torch.where(state.cell_wall, -2, state.cell_slot)
    if spec.food_mode:
        enc = torch.where(state.cell_food >= 0.0, -3, enc)
    return enc


def _turn_phase(spec, T, state: State):
    """Turn actions (turn mode; engine.py:896-970, reference
    GridWorld.cc:544-571, Map::do_turn Map.cc:361-406): a turner's body
    takes its new facing's rect about the turn anchor; turns whose rect is
    blank at phase start (walls, food and other agents block) and claimed
    by no lower slot commit together, as moves do.

    The reference quirk is kept: turn actions are buffered as the absolute
    action index, so the facing advances by ``2 * act - 1`` (mod 4) while
    the body always takes do_turn's clockwise branch.  The turn offsets are
    0, so the anchor is the body's direction corner itself and the
    clockwise rotation about it leaves it in place: the new rect is the one
    whose new-facing corner is the old corner."""
    H, W = spec.height, spec.width
    act = state.last_action
    alive = state.active & ~state.dead
    is_turn = alive & (act >= T.turn_base) & (act < T.attack_base)
    new_dir = (state.dir + 2 * act - 1) % 4
    rx, ry = geo.save_to_real(state.x, state.y, state.dir, T.width, T.length)
    sx, sy = geo.real_to_save(rx, ry, new_dir, T.width, T.length)
    nbw, nbh = geo.size_for_dir(new_dir, T.width, T.length)
    in_bounds = (sx >= 0) & (sy >= 0) & (sx + nbw < W) & (sy + nbh < H)

    body, cell, claim_cell = _rect_cells(spec, T, sx, sy, nbw, nbh)
    e = _from_cells(_grid_at(_move_enc(spec, state), cell), body.shape[0])
    blocked = is_turn & body & (e != -1) & (e != T.slots)
    blank = is_turn & in_bounds & ~blocked.any(0)
    success, _, _ = _claim_rects(spec, T, blank, body, claim_cell)

    cell_slot = _set_bodies(state.cell_slot, success, state.x, state.y, T,
                            state.dir, -1)
    cell_slot = _set_bodies(cell_slot, success, sx, sy, T, new_dir, T.slots)
    return state.replace(
        x=torch.where(success, sx, state.x),
        y=torch.where(success, sy, state.y),
        dir=torch.where(success, new_dir, state.dir),
        cell_slot=cell_slot,
    )


def make_step(spec: speclib.GameSpec, *, maintain_grid: bool = True,
              walls=None, n_envs: int = 1):
    """Build ``step(state, actions=None) -> State``.

    The route is decided here, once (engine.py:993-1020 without its env-var
    overrides): the pair kernels serve up to ``QUAD_MAX_SINGLE`` slots for a
    single world and ``QUAD_MAX_AGENTS`` for a batch, and one multi-cell
    world of ``QUAD_MAX_SINGLE`` to ``SEG_DEFAULT_MAX`` slots takes the
    y-segmented sweeps.  ``maintain_grid=False`` takes the gridless path
    where the spec has no food, turn mode or absorb and one of those holds;
    everything else takes the grid path, whose damage and 1x1 claims go
    through the pair kernels within the cap and through sorts above it.

    ``walls``: the static full [H, W] bool wall map of a lockstep layout;
    where it has interior walls, the gridless step answers wall questions
    from its packed overlap grid (:func:`_wall_rect_code`).  ``None``, or a
    map of border walls only, is answered by formula.  The grid path reads
    ``state.cell_wall`` and ignores it."""
    A = spec.n_agents_cap
    quad = A <= (ap.QUAD_MAX_SINGLE if n_envs == 1 else ap.QUAD_MAX_AGENTS)
    seg = (spec.max_body_w > 1 and n_envs == 1
           and ap.QUAD_MAX_SINGLE <= A <= SEG_DEFAULT_MAX)
    if not maintain_grid and _gridless_capable(spec) and (quad or seg):
        route = _Route(grid=False, quad=True, seg=seg)
    else:
        route = _Route(grid=True, quad=quad)
    # the segmented sweeps' y-margins (_Tables.att_reach_y, max_dy) are
    # NORTH-frame bounds: sound only where every body faces NORTH
    assert not (route.seg and spec.turn_mode)
    wall_ctx = None
    if not route.grid and walls is not None:
        walls = np.asarray(walls, bool)
        interior = walls.copy()
        interior[0, :] = interior[-1, :] = False
        interior[:, 0] = interior[:, -1] = False
        if interior.any():
            wall_ctx = _wall_rect_code(spec, walls)
    return _build_step(spec, route, wall_ctx)


def _build_step(spec: speclib.GameSpec, route: _Route, wall_ctx=None):
    """The step on a fixed route (tests pick the sort branches and the
    segmented sweeps here)."""
    if not (route.grid or route.quad):
        raise ValueError("the gridless path has no sort branch")
    if not (route.grid or _gridless_capable(spec)):
        raise ValueError("food, turn mode and absorb run on the grid path "
                         "only")
    if route.seg and (route.grid or spec.max_body_w == 1):
        raise ValueError("the segmented sweeps serve gridless multi-cell "
                         "specs only")
    rules = spec.compiled_rules()
    A = spec.n_agents_cap
    absorb = bool(spec.g_can_absorb.any())
    cache: dict = {}

    def step(state: State, actions=None) -> State:
        T = _tables_for(spec, cache, state.x.device, wall_ctx)
        if actions is not None:
            state = state.replace(last_action=torch.as_tensor(
                actions, device=state.x.device).to(torch.int32))
        key, rank = attack_rank(state, A)
        state = state.replace(key=key)

        seg_ctx = _seg_order(state) if route.seg else None
        state = _attack_phase(spec, T, state, rank, route, seg_ctx)
        state = _starve_phase(spec, T, state, route)
        if spec.turn_mode:
            state = _turn_phase(spec, T, state)
        state = _move_phase(spec, T, state, route, seg_ctx)

        # reward rules (reference: GridWorld::calc_reward, GridWorld.cc:681-692)
        next_reward, group_reward = state.next_reward, state.group_reward
        terminal = torch.zeros_like(state.done)
        for rule in rules:
            next_reward, group_reward, trig = rule.apply(
                spec, state, next_reward, group_reward)
            if rule.is_terminal:
                terminal = terminal | trig
        state = state.replace(next_reward=next_reward,
                              group_reward=group_reward)

        # done: any group extinct (GridWorld.cc:618-630); absorbed
        # colliders never count as dead (Map.cc:340-353): a dead agent whose
        # collide object is absorbed died that way (engine.py:1073-1084)
        counted_dead = state.dead
        if absorb:
            counted_dead = counted_dead & ~(
                (state.last_op == OP_COLLIDE)
                & _pad_gather(state.absorbed, state.op_obj, False))
        alive = state.active & ~counted_dead
        alive_per_group = torch.stack(
            [alive[:, g.offset:g.offset + g.cap].sum(-1) for g in spec.groups],
            dim=-1)
        done = (alive_per_group == 0).any(-1) | terminal
        return state.replace(done=done, step_ct=state.step_ct + 1)

    step.route = route
    return step


def make_clear_dead(spec: speclib.GameSpec):
    """Build ``clear_dead(state) -> State``: stable per-group compaction of
    the live agents and the per-step reward/op reset (engine.py:1099-1155;
    reference GridWorld::clear_dead GridWorld.cc:633-665,
    Agent::init_reward GridWorld.h:168-174)."""
    A, G = spec.n_agents_cap, spec.n_groups
    cache: dict = {}

    def consts(device):
        if device not in cache:
            as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
            cache[device] = (as_t(spec.group_offsets, torch.int64),
                             as_t(spec.group_of_slot, torch.int64),
                             as_t(spec.s_step_reward, torch.float32),
                             torch.arange(A, dtype=torch.int64, device=device))
        return cache[device]

    def clear_dead(state: State) -> State:
        B = state.x.shape[0]
        H, W = state.cell_slot.shape[1:]
        offsets, gidx, step_reward, slots = consts(state.x.device)
        keep = state.active & ~state.dead
        keep_i = keep.to(torch.int64)
        cum = keep_i.cumsum(-1)
        base = (cum - keep_i)[:, offsets]  # exclusive count at group starts
        new_slot = offsets[gidx] + cum - 1 - base[:, gidx]  # valid where keep

        # inverse permutation: which old slot fills each new slot
        inv = torch.full((B, A + 1), -1, dtype=torch.int64,
                         device=keep.device).scatter(
            1, torch.where(keep, new_slot, A), slots.expand(B, A))[:, :A]
        filled = inv >= 0
        invc = inv.clamp(0, A - 1)

        def permute(t, default):
            return torch.where(filled, torch.gather(t, 1, invc), default)

        # remap grid occupancy to the compacted slots
        remap = torch.full((B, A + 1), -1, dtype=torch.int64,
                           device=keep.device).scatter(
            1, torch.where(keep, slots, A), new_slot)[:, :A]
        occ = state.cell_slot.reshape(B, H * W)
        occ = torch.where(occ >= 0, torch.gather(remap, 1, occ.clamp(0, A - 1)
                                                 .long()), occ.long())
        return state.replace(
            x=permute(state.x, 0),
            y=permute(state.y, 0),
            dir=permute(state.dir, NORTH),
            hp=permute(state.hp, 0.0),
            active=filled,
            dead=torch.zeros_like(state.dead),
            absorbed=permute(state.absorbed, False),
            id=permute(state.id, 0),
            last_action=permute(state.last_action, 0),
            # init_reward: last <- next, next <- step_reward
            last_reward=permute(state.next_reward, 0.0),
            next_reward=torch.where(filled, step_reward, 0.0),
            last_op=torch.full_like(state.last_op, OP_NULL),
            op_obj=torch.full_like(state.op_obj, -1),
            group_reward=torch.zeros_like(state.group_reward),
            n_in_group=torch.stack(
                [filled[:, g.offset:g.offset + g.cap].sum(-1)
                 for g in spec.groups], -1).to(torch.int32),
            cell_slot=occ.to(torch.int32).reshape(B, H, W),
        )

    return clear_dead
