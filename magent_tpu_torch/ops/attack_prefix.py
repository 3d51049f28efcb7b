"""Pairwise O(A^2) conflict-resolution kernels of the gridless engine step.

For every query slot j the engine needs one answer over all slots i of the
same env (reference semantics and the pairwise formulations:
``magent_tpu/ops/attack_prefix.py``):

- :func:`occupant` — which live agent stands on the attacked cell;
- :func:`rank_prefix` — damage dealt to the same target by attackers of
  lower random rank (the reference shuffles its attack buffer,
  GridWorld.cc:464-468);
- :func:`move_resolve` — move contention and blocking;
- :func:`move_claims` — move contention alone (the grid path answers
  blocking from its occupancy grid);
- :func:`occupant_rect` — which body rect contains the attacked cell
  (multi-cell bodies);
- :func:`rect_first_overlap` — the first body a query rect overlaps in the
  grid path's cell scan order (multi-cell move blocking and claims).

Each has a plain PyTorch version (``*_ref``, ports of the JAX package's
``*_xla`` functions, materializing the ``[B, A, A]`` pair mask) and a wrapper
that launches the CUDA kernel of ``csrc/pair_kernels.cu`` on CUDA tensors and
calls the plain version on CPU tensors.  All take batched ``[B, A]``
operands; one launch covers the whole env batch.

One big world (``QUAD_MAX_SINGLE`` to 65,536 slots) of multi-cell bodies
takes the y-segmented forms instead: :func:`occupant_rect_seg`,
:func:`rect_first_overlap_seg` and :func:`rank_prefix_seg` take [A]
operands sorted by y and sweep each 1024-row segment of queries against a
window of nearby rows only (kernels: the first two on the split template
of ``csrc/pair_kernels.cu``, the overlap sweep in ``csrc/seg_kernels.cu``).
"""

from __future__ import annotations

import torch

from . import _build

# above these capacities the engine routes conflict resolution to its sort
# branches instead of the O(A^2) pair sweeps: batched worlds at
# QUAD_MAX_AGENTS, a single world at QUAD_MAX_SINGLE (the JAX package's
# bounds, magent_tpu/ops/attack_prefix.py:51-52)
QUAD_MAX_AGENTS = 8192
QUAD_MAX_SINGLE = 16384

# sentinels of the gridless engine: an empty query, a dead agent's cell —
# distinct, so a dead cell never satisfies a (sentinel) query
QUERY_NONE = 2**30
CELL_DEAD = 2**29

# sentinels of the rect kernels (multi-cell bodies): a non-query's
# coordinate (with an empty rect, bw = bh = 0, which contains no cell and
# overlaps nothing), and the "no slot" answer of rect_first_overlap
RECT_PAD = -2**20
RECT_NONE = 2**30
_NONE_KEY = 2**31 - 1  # empty min-reduction of rect_first_overlap


def pack_rank(bits: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Pack random bits (uint32 words in int64, ``[..., A]``) + slot index
    into one strictly ordering int32 key (``magent_tpu/ops/attack_prefix.py``
    pack_rank): random high bits, slot index low bits as tie-break."""
    slot_bits = max(1, (n_slots - 1).bit_length())
    if slot_bits > 24:
        raise ValueError("pack_rank supports up to 2**24 slots, got %d" % n_slots)
    rand_bits = 31 - slot_bits
    slot = torch.arange(n_slots, dtype=torch.int64, device=bits.device)
    return (((bits >> (32 - rand_bits)) << slot_bits) | slot).to(torch.int32)


def _slots_col(A: int, device):
    return torch.arange(A, dtype=torch.int64, device=device)[:, None]


def _pair_operands(name: str, ints, floats=()):
    """Validate batched pair-kernel operands; returns (B, A, device)."""
    B, A = ints[0].shape
    device = ints[0].device
    for i, t in enumerate(ints):
        _build.check(t, "%s operand %d" % (name, i), torch.int32, (B, A), device)
    for i, t in enumerate(floats):
        _build.check(t, "%s float operand %d" % (name, i), torch.float32,
                     (B, A), device)
    if B > 65535:
        raise ValueError("%s: at most 65535 envs per launch, got %d" % (name, B))
    return B, A, device


# ------------------------------------------------------------------ occupant
def occupant_ref(acell, cell, hp):
    """Plain version (port of ``occupant_xla``): (slot whose own cell equals
    ``acell_j``, summed over matches, or -1; the matches' summed hp)."""
    m = cell[..., :, None] == acell[..., None, :]  # [..., i, j]
    cnt = m.sum(-2)
    slot_sum = (m * _slots_col(acell.shape[-1], acell.device)).sum(-2)
    hp_sum = (m * hp[..., :, None]).sum(-2)
    return (torch.where(cnt > 0, slot_sum, -1).to(torch.int32),
            hp_sum.to(hp.dtype))


def occupant(acell, cell, hp):
    """Occupant lookup: ``acell`` [B, A] int32 queried cell (``QUERY_NONE``
    when not querying), ``cell`` [B, A] int32 own cell (``CELL_DEAD`` when
    dead), ``hp`` [B, A] f32 -> (tgt [B, A] int32, hp_t [B, A] f32).

    Replaces ``magent_tpu/ops/attack_prefix.py:285`` ``occupant_tpu``.
    Bound on the card: one int32 compare per pair over B*A^2 pairs, and a
    count, a slot add and an hp add per query that found a slot; the
    operands are KBs.  Design: ``csrc/pair_kernels.cu`` on the split
    template of :func:`rank_prefix` — 4 queries per thread against
    partners staged as one int2 (cell, hp bits), the partner axis cut over
    the warps of a thread-block cluster (:func:`rect_split`,
    :func:`rect_bounds` without the gate); per partner the warp votes on
    its 4 x 32 compares and updates its queries only where one matched (in
    the engine a query matches at most one slot); the partials (count,
    slot sum, hp sum) folded in range order through distributed shared
    memory.  Keeps the xla sum-over-matches semantics (the TPU kernel's
    per-chunk overwrite agrees only when cells are unique): ints exact,
    ``hp_t`` bit for bit wherever a query matches at most two slots, else
    within rounding (the sum runs range by range)."""
    if _build.route(acell, cell, hp) == "cpu":
        return occupant_ref(acell, cell, hp)
    B, A, device = _pair_operands("occupant", (acell, cell), (hp,))
    return _occupant_launch(acell, cell, hp, _rect_split_on(device, B, A))


def _occupant_launch(acell, cell, hp, split):
    """Launch the occupant kernel with ``split = (cluster, warps)``."""
    B, A = acell.shape
    tgt = torch.empty((B, A), dtype=torch.int32, device=acell.device)
    hp_t = torch.empty((B, A), dtype=torch.float32, device=acell.device)
    if A:
        _build.launch("magent_occupant", acell.device, acell.data_ptr(),
                      cell.data_ptr(), hp.data_ptr(), B, A, *split,
                      tgt.data_ptr(), hp_t.data_ptr())
    return tgt, hp_t


# --------------------------------------------------------------- rank prefix
def _rank_pairs(tq, rq, tb, rb, db):
    """``P_j = sum_i [tb_i == tq_j and rb_i < rq_j] * db_i`` for queries
    [..., R] against partners [..., P] -> [..., R]."""
    m = (tb[..., :, None] == tq[..., None, :]) & (
        rb[..., :, None] < rq[..., None, :])
    return (m * db[..., :, None]).sum(-2).to(db.dtype)


def rank_prefix_ref(tgt, rank, dmg, hp=None):
    """Plain version (port of ``rank_prefix_xla``):
    ``P_j = sum_i [tgt_i == tgt_j and rank_i < rank_j] * dmg_i``; with ``hp``
    also ``hp_t_j = sum_i [i == tgt_j] * hp_i`` (0 for the sentinel A)."""
    P = _rank_pairs(tgt, rank, tgt, rank, dmg)
    if hp is None:
        return P
    sel = _slots_col(tgt.shape[-1], tgt.device) == tgt[..., None, :]
    return P, (sel * hp[..., :, None]).sum(-2).to(hp.dtype)


def rank_prefix(tgt, rank, dmg, hp=None):
    """Order-aware damage prefix: ``tgt`` [B, A] int32 target slot (A for
    non-attackers), ``rank`` [B, A] int32 strict priority (:func:`pack_rank`),
    ``dmg`` [B, A] f32 -> P [B, A] f32; with ``hp`` [B, A] f32 -> (P, hp_t),
    ``hp_t`` the target's hp (0 for the sentinel A).

    Replaces ``magent_tpu/ops/attack_prefix.py:128`` ``rank_prefix_tpu``:
    the no-hp form (``:184-199``, the gridless path) and the hp form
    (``:152-182``, the grid path).  Bound on the card: 2 int32 instructions
    per pair (the target compare, and the rank compare ANDed into its
    predicate) and 1 f32 (a predicated add) over B*A^2 pairs, so the
    int32 pipe bounds it; the hp form adds one load per query.  Design:
    ``csrc/pair_kernels.cu`` on the rect sweeps' split template — 4
    queries per thread against partner records (tgt, rank, dmg) staged as
    one int4, the partner axis cut over the warps of a thread-block
    cluster (:func:`rect_split`, :func:`rect_bounds` without the gate) and
    the partials folded in range order through distributed shared memory.
    The f32 sum runs in slot order within a range, then range by range: it
    is deterministic for a given ``(B, A)`` and card (the split depends on
    the SM count), and may differ from the plain version's reduction order
    in the last bits for general damages; integer-valued damages (battle's
    2, pursuit's) sum exactly.  ``hp_t`` is one direct load per query,
    equal to the one-hot sum bit for bit.  Sentinel rows (tgt = A) match
    one another, as in the plain version."""
    operands = (tgt, rank, dmg) + (() if hp is None else (hp,))
    if _build.route(*operands) == "cpu":
        return rank_prefix_ref(tgt, rank, dmg, hp)
    B, A, device = _pair_operands("rank_prefix", (tgt, rank), operands[2:])
    return _rank_prefix_launch(tgt, rank, dmg, hp,
                               _rect_split_on(device, B, A))


def _rank_prefix_launch(tgt, rank, dmg, hp, split):
    """Launch the rank_prefix kernel (the hp form with ``hp``) with ``split
    = (cluster, warps)``."""
    B, A = tgt.shape
    P = torch.empty((B, A), dtype=torch.float32, device=tgt.device)
    if hp is None:
        if A:
            _build.launch("magent_rank_prefix", tgt.device, tgt.data_ptr(),
                          rank.data_ptr(), dmg.data_ptr(), B, A, *split,
                          P.data_ptr())
        return P
    hp_t = torch.empty((B, A), dtype=torch.float32, device=tgt.device)
    if A:
        _build.launch("magent_rank_prefix_hp", tgt.device, tgt.data_ptr(),
                      rank.data_ptr(), dmg.data_ptr(), hp.data_ptr(), B, A,
                      *split, P.data_ptr(), hp_t.data_ptr())
    return P, hp_t


# -------------------------------------------------------------- move resolve
def move_resolve_ref(tcell, cell):
    """Plain version (port of ``move_resolve_xla``): (count of lower slots
    with the same target, lowest slot with the same target — self included,
    so never the sentinel A — and the other slot standing on the target
    cell, summed over matches, or -1)."""
    A = tcell.shape[-1]
    slots = _slots_col(A, tcell.device)
    same = tcell[..., :, None] == tcell[..., None, :]
    cnt = (same & (slots < slots.T)).sum(-2)
    head = torch.where(same, slots, A).amin(-2)
    occ_m = (cell[..., :, None] == tcell[..., None, :]) & (slots != slots.T)
    occ_cnt = occ_m.sum(-2)
    occ_sum = (occ_m * slots).sum(-2)
    occ = torch.where(occ_cnt > 0, occ_sum, -1)
    return cnt.to(torch.int32), head.to(torch.int32), occ.to(torch.int32)


def move_resolve(tcell, cell):
    """Gridless move arbitration: ``tcell`` [B, A] int32 target cell
    (``QUERY_NONE`` for non-movers), ``cell`` [B, A] int32 own cell
    (``CELL_DEAD`` when dead) -> (cnt, head, occ), each [B, A] int32.

    Replaces ``magent_tpu/ops/attack_prefix.py:346`` ``move_resolve_tpu``.
    Bound on the card: 12 integer ops per pair (count 4, head 2,
    occupant 6) over B*A^2 pairs.  Design: ``csrc/pair_kernels.cu`` —
    one thread per query, i-operands staged in shared memory tiles,
    ascending i, one launch for the env batch; three results from one
    sweep."""
    if _build.route(tcell, cell) == "cpu":
        return move_resolve_ref(tcell, cell)
    B, A, device = _pair_operands("move_resolve", (tcell, cell))
    cnt = torch.empty((B, A), dtype=torch.int32, device=device)
    head = torch.empty((B, A), dtype=torch.int32, device=device)
    occ = torch.empty((B, A), dtype=torch.int32, device=device)
    if A:
        _build.launch("magent_move_resolve", device, tcell.data_ptr(),
                      cell.data_ptr(), B, A, cnt.data_ptr(), head.data_ptr(),
                      occ.data_ptr())
    return cnt, head, occ


# --------------------------------------------------------------- move claims
def move_claims_ref(tcell):
    """Plain version (port of ``move_claims_xla``): (count of lower slots
    with the same target cell, lowest slot with the same target cell — self
    included, so never the sentinel A)."""
    A = tcell.shape[-1]
    slots = _slots_col(A, tcell.device)
    same = tcell[..., :, None] == tcell[..., None, :]
    cnt = (same & (slots < slots.T)).sum(-2)
    head = torch.where(same, slots, A).amin(-2)
    return cnt.to(torch.int32), head.to(torch.int32)


def move_claims(tcell):
    """Grid-path move contention: ``tcell`` [B, A] int32 target cell (one
    shared sentinel for non-movers) -> (cnt, head), each [B, A] int32.

    Replaces ``magent_tpu/ops/attack_prefix.py:223`` ``move_claims_tpu``.
    A slot always matches itself, so ``head_j = min(j, min{i < j : tcell_i
    == tcell_j})`` and both results need only the B*A*(A-1)/2 pairs i < j.
    Bound on the card: 3 int32 instructions per pair (a compare, a
    predicated add, a predicated min).  Design: ``csrc/pair_kernels.cu``
    on the split template, as :func:`rect_first_overlap`'s ``lower_only``
    form sweeps it — 4 queries per thread against partner cells staged as
    one int, each tile's lower partner range cut over the warps of a
    thread-block cluster (:func:`rect_split`, :func:`rect_bounds` with
    ``lower_only``, the heaviest tiles first), the i < j gate compared only
    on the tile's own slots, the partials (cnt, head) folded by an add and
    a min: exact in every split.  Sentinel rows count one another, as in
    the plain version; the engine masks them."""
    if _build.route(tcell) == "cpu":
        return move_claims_ref(tcell)
    B, A, device = _pair_operands("move_claims", (tcell,))
    return _move_claims_launch(tcell, _rect_split_on(device, B, A))


def _move_claims_launch(tcell, split):
    """Launch the move_claims kernel with ``split = (cluster, warps)``."""
    B, A = tcell.shape
    cnt = torch.empty((B, A), dtype=torch.int32, device=tcell.device)
    head = torch.empty((B, A), dtype=torch.int32, device=tcell.device)
    if A:
        _build.launch("magent_move_claims", tcell.device, tcell.data_ptr(),
                      B, A, *split, cnt.data_ptr(), head.data_ptr())
    return cnt, head


# -------------------------------------------------------- rect sweep splits
# Launch geometry of the split template (occupant, move_claims, rank_prefix,
# occupant_rect and rect_first_overlap in csrc/pair_kernels.cu): query
# tiles of RECT_TILE slots
# (32 lanes holding 4 queries each); a tile's partner axis is cut into
# cluster * warps contiguous ranges of equal slots, one per warp of each
# CTA of a thread-block cluster, folded in range order.
RECT_TILE = 128
RECT_WARPS = 8
RECT_MAX_CLUSTER = 8
# the kernels' range arithmetic is 32-bit: 64 ranges * A < 2^31
RECT_MAX_SLOTS = 2**24
# where lone CTAs leave SMs idle, the cluster grows until the grid holds
# this many CTAs per SM (a fine enough grain that the SMs' shares of the
# work even out) or until a warp's range would drop below this many
# partners (its fixed costs would dominate)
_RECT_CTAS_PER_SM = 4
_RECT_MIN_RANGE = 16


def rect_split(B: int, A: int, n_sms: int):
    """(cluster, warps) of a split-template sweep over ``B`` envs of ``A``
    slots on a card of ``n_sms`` SMs: warps per CTA ``RECT_WARPS``; lone
    CTAs where they already put one on every SM (battle's ``rank_prefix``,
    B=16: a cluster's syncs and shorter ranges only add there), else CTAs
    per cluster the smallest power of two up to ``RECT_MAX_CLUSTER`` that
    puts ``_RECT_CTAS_PER_SM`` CTAs on every SM, while each warp's range
    keeps ``_RECT_MIN_RANGE`` partners."""
    if A > RECT_MAX_SLOTS:
        raise ValueError("the rect sweeps take at most %d slots, got %d"
                         % (RECT_MAX_SLOTS, A))
    n_tiles = -(-A // RECT_TILE)
    cluster = 1
    while (cluster < RECT_MAX_CLUSTER and B * n_tiles < n_sms
           and B * n_tiles * cluster < _RECT_CTAS_PER_SM * n_sms
           and A >= 2 * cluster * RECT_WARPS * _RECT_MIN_RANGE):
        cluster *= 2
    return cluster, RECT_WARPS


def rect_bounds(t: int, n: int, A: int, lower_only: bool):
    """The body ranges of query tile ``t`` (slots ``[t0, t1)``) cut ``n``
    ways: ``n + 1`` ascending bounds, range s = ``[b[s], b[s+1])`` (the
    Python twin of ``rect_range`` in csrc/pair_kernels.cu): equal slots of
    ``[0, A)``, or with ``lower_only`` of ``[0, t1 - 1)`` (no body at or
    above ``t1 - 1`` has a pair i < j with the tile).  Every warp holds all
    the tile's queries, so a body costs the same whether its pairs pass
    the gate or not: equal slots balance the warps."""
    end = min(A, (t + 1) * RECT_TILE) - 1 if lower_only else A
    return [s * end // n for s in range(n + 1)]


def _rect_split_on(device, B: int, A: int):
    return rect_split(B, A, _build.sm_count(device))


# ------------------------------------------------------------ occupant rect
def _occupant_rect_pairs(qx, qy, x, y, bw, bh, hp, bslot, qslot=None):
    """Queries [..., R] against body rects [..., P] carrying slot ids
    ``bslot``: (the largest id whose rect contains the query cell, or -1;
    the matches' summed hp); with ``qslot``, a body never answers the query
    of its own id."""
    m = ((qx[..., None, :] >= x[..., :, None])
         & (qx[..., None, :] < (x + bw)[..., :, None])
         & (qy[..., None, :] >= y[..., :, None])
         & (qy[..., None, :] < (y + bh)[..., :, None]))  # [..., i, j]
    if qslot is not None:
        m = m & (bslot[..., :, None] != qslot[..., None, :])
    tgt = torch.where(m, bslot[..., :, None], -1).amax(-2)
    hp_t = torch.where(m, hp[..., :, None], 0.0).sum(-2)
    return tgt.to(torch.int32), hp_t.to(hp.dtype)


def occupant_rect_ref(qx, qy, x, y, bw, bh, hp, *, exclude_self=False):
    """Plain version (port of ``occupant_rect_xla``): (the largest slot whose
    body rect [x, x+bw) x [y, y+bh) contains query cell (qx_j, qy_j), or -1;
    the matches' summed hp)."""
    slots = torch.arange(qx.shape[-1], device=qx.device)
    return _occupant_rect_pairs(qx, qy, x, y, bw, bh, hp, slots,
                                slots if exclude_self else None)


def occupant_rect(qx, qy, x, y, bw, bh, hp, *, exclude_self=False):
    """Rect occupant lookup: ``qx``/``qy`` [B, A] int32 query cell
    (``RECT_PAD`` for non-queries), ``x``/``y``/``bw``/``bh`` [B, A] int32
    body rects (``bw = bh = 0`` for the dead), ``hp`` [B, A] f32 ->
    (tgt [B, A] int32, hp_t [B, A] f32).

    Replaces ``magent_tpu/ops/attack_prefix.py:430`` ``occupant_rect_tpu``
    (without its ``bslot`` operand, which only the segmented path passes).
    Bound on the card: 5 integer instructions per pair (four compares that
    AND into one predicate, a predicated slot move; the ``exclude_self``
    compare on the tile's own slots) and one f32 add, over B*A^2 pairs; the
    operands are KBs.  Design: ``csrc/pair_kernels.cu`` — 4 queries per
    thread against body edges staged in shared memory as one int4, the body
    axis split over the warps of a thread-block cluster (:func:`rect_split`)
    and combined in range order through distributed shared memory; slots
    ascend within a range, so a range's last match is its max.  Bodies are
    disjoint, so at most one slot matches and ``hp_t`` equals the plain
    version bit for bit."""
    ints = (qx, qy, x, y, bw, bh)
    if _build.route(*ints, hp) == "cpu":
        return occupant_rect_ref(qx, qy, x, y, bw, bh, hp,
                                 exclude_self=exclude_self)
    B, A, device = _pair_operands("occupant_rect", ints, (hp,))
    return _occupant_rect_launch(ints, hp, exclude_self,
                                 _rect_split_on(device, B, A))


def _occupant_rect_launch(ints, hp, exclude_self, split):
    """Launch the occupant_rect kernel with ``split = (cluster, warps)``."""
    B, A = hp.shape
    tgt = torch.empty((B, A), dtype=torch.int32, device=hp.device)
    hp_t = torch.empty((B, A), dtype=torch.float32, device=hp.device)
    if A:
        _build.launch("magent_occupant_rect", hp.device,
                      *(t.data_ptr() for t in ints), hp.data_ptr(), B, A,
                      int(exclude_self), *split, tgt.data_ptr(),
                      hp_t.data_ptr())
    return tgt, hp_t


# ------------------------------------------------------- rect first overlap
_GATES = ("exclude_self", "lower_only")


def _rect_stride(A: int, max_body: int, gate: str) -> int:
    """Key stride ``2**30 // max_body**2`` (k < max_body^2, slot < A <=
    stride), after validating the static arguments."""
    if gate not in _GATES:
        raise ValueError("gate must be one of %s, got %r" % (_GATES, gate))
    stride = RECT_NONE // (max_body * max_body)
    if A > stride:
        raise ValueError("rect_first_overlap: %d slots exceed the key stride "
                         "%d of max_body %d" % (A, stride, max_body))
    return stride


def _rect_overlap_keys(q, b, max_body, gate, stride):
    """Query rects ``q = (qx, qy, tbw, tbh, qslot)`` [..., R] against body
    rects ``b = (x, y, bw, bh, bslot)`` [..., P], both carrying slot ids:
    per query, the min over gated bodies of the int64 key ``k * stride +
    bslot``, or ``_NONE_KEY``.  The gates compare the ids, never
    positions."""
    qx, qy, tbw, tbh, qslot = q
    x, y, bw, bh, bslot = b
    ox = torch.maximum(qx[..., None, :], x[..., :, None])
    oy = torch.maximum(qy[..., None, :], y[..., :, None])
    ex = torch.minimum((qx + tbw)[..., None, :], (x + bw)[..., :, None])
    ey = torch.minimum((qy + tbh)[..., None, :], (y + bh)[..., :, None])
    bs, qs = bslot[..., :, None], qslot[..., None, :]
    ov = (ox < ex) & (oy < ey) & (bs != qs if gate == "exclude_self"
                                  else bs < qs)
    k = (ox - qx[..., None, :]) * max_body + (oy - qy[..., None, :])
    key = torch.where(ov, k, 0).to(torch.int64) * stride + bs
    return torch.where(ov, key, _NONE_KEY).amin(-2)


def _rect_overlap_pairs(q, b, max_body, gate, stride):
    """:func:`_rect_overlap_keys` decoded to the slot, or ``RECT_NONE``."""
    best = _rect_overlap_keys(q, b, max_body, gate, stride)
    return torch.where(best == _NONE_KEY, RECT_NONE, best % stride).to(
        torch.int32)


def rect_first_overlap_ref(qx, qy, tbw, tbh, x, y, bw, bh, *, max_body,
                           gate):
    """Plain version (port of ``rect_first_overlap_xla``): per query rect
    [qx, qx+tbw) x [qy, qy+tbh), the min over gated bodies i of the key
    ``k * stride + i``, k the first overlapped cell in the (i outer, j
    inner) scan order, ``(max(qx, x) - qx) * max_body + max(qy, y) - qy``;
    returns the key's slot, or ``RECT_NONE`` when nothing overlaps."""
    A = qx.shape[-1]
    stride = _rect_stride(A, max_body, gate)
    slots = torch.arange(A, device=qx.device)
    return _rect_overlap_pairs((qx, qy, tbw, tbh, slots),
                               (x, y, bw, bh, slots), max_body, gate, stride)


def rect_first_overlap(qx, qy, tbw, tbh, x, y, bw, bh, *, max_body, gate):
    """First overlap of query rects with body rects: ``qx``/``qy``/``tbw``/
    ``tbh`` [B, A] int32 query rects (``RECT_PAD`` with an empty rect for
    non-queries), ``x``/``y``/``bw``/``bh`` [B, A] int32 body rects,
    ``gate`` ``"exclude_self"`` (bodies i != j) or ``"lower_only"`` (i < j),
    static ``max_body`` -> [B, A] int32 slot or ``RECT_NONE``.

    Replaces ``magent_tpu/ops/attack_prefix.py:586`` ``rect_first_overlap_tpu``
    (without its ``qslot``/``bslot`` operands, which only the segmented path
    passes).  Bound on the card: 8 integer instructions per pair (four
    edge compares that AND into one predicate, two add-max and an add for
    the key, a predicated min; the gate compare only on the tile's own
    slots) over B*A^2 pairs for ``exclude_self`` and the B*A*(A-1)/2 pairs
    i < j for ``lower_only``.  Design: ``csrc/pair_kernels.cu`` — 4
    query rects per thread; a body staged once as its edges (an empty rect
    moved out of reach, so four compares decide an overlap) and its two
    scaled key terms, so a pair's key is two add-max and an add; the body
    axis split over the warps of a thread-block cluster (:func:`rect_split`,
    :func:`rect_bounds`), the partial keys' min taken in range order
    through distributed shared memory.  Ints: equal to the plain version
    exactly."""
    A = qx.shape[-1]
    stride = _rect_stride(A, max_body, gate)
    ints = (qx, qy, tbw, tbh, x, y, bw, bh)
    if _build.route(*ints) == "cpu":
        return rect_first_overlap_ref(*ints, max_body=max_body, gate=gate)
    B, A, device = _pair_operands("rect_first_overlap", ints)
    return _rect_first_overlap_launch(ints, max_body, gate, stride,
                                      _rect_split_on(device, B, A))


def _rect_first_overlap_launch(ints, max_body, gate, stride, split):
    """Launch the rect_first_overlap kernel with ``split = (cluster,
    warps)``."""
    B, A = ints[0].shape
    out = torch.empty((B, A), dtype=torch.int32, device=ints[0].device)
    if A:
        _build.launch("magent_rect_first_overlap", ints[0].device,
                      *(t.data_ptr() for t in ints), B, A, stride,
                      int(max_body), int(gate == "lower_only"), *split,
                      out.data_ptr())
    return out


# ----------------------------------------------------- y-segmented sweeps
# A single world of QUAD_MAX_SINGLE to SEG_DEFAULT_MAX slots presents its
# operands sorted by y; each SEG_ROWS-row segment of queries sweeps only
# the contiguous window of sorted rows within ``margin`` of its y-range
# (magent_tpu/ops/attack_prefix.py:751-1007).  The window is a static
# width, rounded to _SEG_ALIGN rows as the JAX package rounds it to its
# partner chunk, so that the two packages plan the same windows; a window
# that would need more rows sets the plan's ``overflow`` flag, and the call
# then sweeps every row.
SEG_ROWS = 1024
SEG_WIN = 2048
_SEG_ALIGN = 512
# pad sentinels of the sorted operands: queries sit at RECT_PAD with an
# empty rect, sort_y past every real row, targets at QUERY_NONE with rank 0
# and damage 0
SEG_Y_PAD = 2**20


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pad_operands_to(Ap, pads):
    """Sentinel-pad 1-D operands ``(tensor, fill)`` to exactly Ap rows."""
    return [t if t.shape[0] == Ap else
            torch.cat([t, t.new_full((Ap - t.shape[0],), fill)])
            for t, fill in pads]


def _seg_plan(sort_y, margin, seg_win=None):
    """Partner-window plan of a y-sorted population of A rows, padded to
    ``Ap = ceil(A / SEG_ROWS) * SEG_ROWS``: (S segments, window width P,
    ``start`` [S] int32 first window row, ``overflow`` 0-dim bool: some
    segment needs more than P rows).  All on the operands' device; nothing
    is read back.

    Unlike the JAX package's ``_seg_plan``, the boundary segment's ``ymax``
    is its last real row's y, not the pad sentinel's, so pad rows never
    widen a window (``ADVICE.md`` item 2).  ``start`` is the same; where A
    is not a multiple of SEG_ROWS, ``overflow`` can only be set less often.
    Results on the real rows are the same either way."""
    A = sort_y.shape[0]
    Ap = _ceil_to(A, SEG_ROWS)
    (sort_y_p,) = _pad_operands_to(Ap, [(sort_y, SEG_Y_PAD)])
    P = min(_ceil_to(seg_win or SEG_WIN, _SEG_ALIGN), Ap)
    S = Ap // SEG_ROWS
    first = torch.arange(S, device=sort_y_p.device) * SEG_ROWS
    ymin = sort_y_p[first]
    last = (first + SEG_ROWS - 1).clamp(max=max(A - 1, 0))
    ymax = torch.where(first < A, sort_y_p[last], ymin)
    lo = torch.searchsorted(sort_y_p, ymin - margin)
    hi = torch.searchsorted(sort_y_p, ymax + margin, right=True)
    start = lo.clamp(max=Ap - P).clamp(min=0)
    overflow = (hi - start > P).any()
    return S, P, start.to(torch.int32), overflow


# Launch split of occupant_rect_seg and rank_prefix_seg on the split
# template: a tile of RECT_TILE sorted query rows lies in one segment
# (SEG_TILES tiles each), and its window of P rows is cut into cluster *
# warps ranges of equal rows (seg_range in csrc/pair_kernels.cu).  One
# world of 37,500 slots is 293 tiles, 2-3 lone CTAs per SM of the H100.
# CTAs of SEG_WARPS warps; the cluster grows until the grid holds
# _SEG_CTAS_PER_SM CTAs per SM (a full SM's 64 warps each: the SMs'
# shares even out) or until a warp's range would drop below _SEG_MIN_RANGE
# rows.  Measured on the H100 (tools/profile_rect.py, PERF.md §6):
# clusters of 8 CTAs of 4 warps were the fastest of the 16 splits for the
# occupant at maps 662 and 1000 and within 0.0001 ms of the fastest for
# the rank sweep at map 1000 (6% behind (2, 8) at map 662).
SEG_TILES = SEG_ROWS // RECT_TILE
SEG_WARPS = 4
_SEG_CTAS_PER_SM = 16
_SEG_MIN_RANGE = 32


def seg_split(A: int, P: int, n_sms: int):
    """(cluster, warps) of a segmented split-template sweep over ``A``
    sorted rows with windows of ``P`` rows on a card of ``n_sms`` SMs:
    warps per CTA ``SEG_WARPS``; CTAs per cluster the smallest power of
    two up to ``RECT_MAX_CLUSTER`` that puts ``_SEG_CTAS_PER_SM`` CTAs on
    every SM, while each warp's range of the window keeps
    ``_SEG_MIN_RANGE`` rows.  The overflow form (the plan's flag is read on
    the device) sweeps ``[0, A)`` with the same split."""
    if A > RECT_MAX_SLOTS:
        raise ValueError("the segmented sweeps take at most %d slots, got %d"
                         % (RECT_MAX_SLOTS, A))
    n_tiles = -(-A // RECT_TILE)
    cluster = 1
    while (cluster < RECT_MAX_CLUSTER
           and n_tiles * cluster < _SEG_CTAS_PER_SM * n_sms
           and P >= 2 * cluster * SEG_WARPS * _SEG_MIN_RANGE):
        cluster *= 2
    return cluster, SEG_WARPS


def seg_bounds(t: int, n: int, A: int, P: int, start, overflow: bool):
    """The window ranges of sorted query tile ``t`` cut ``n`` ways: ``n +
    1`` ascending bounds, range s = ``[b[s], b[s+1])`` (the Python twin of
    ``seg_range`` in csrc/pair_kernels.cu): equal rows of the tile's
    segment's window ``[start[t // SEG_TILES], min(A, start + P))``, or of
    ``[0, A)`` when the plan overflows."""
    begin, end = 0, A
    if not overflow:
        begin = int(start[t // SEG_TILES])
        end = min(A, begin + P)
    length = max(end - begin, 0)
    return [begin + s * length // n for s in range(n + 1)]


def _seg_split_on(device, A: int, P: int):
    return seg_split(A, P, _build.sm_count(device))


def _seg_gather(ops, start, P):
    """[S, P] partner windows ``rows[start_s : start_s + P]`` of 1-D
    padded operands."""
    idx = start.long()[:, None] + torch.arange(P, device=start.device)
    return [op[idx] for op in ops]


def _seg_launch_operands(name, ints, floats, sort_y, margin, seg_win, plan):
    """Validate a segmented kernel's [A] operands and plan its windows
    (unless ``plan`` is given); returns (A, device, P, start, overflow)."""
    A = ints[0].shape[0]
    device = ints[0].device
    for i, t in enumerate(ints):
        _build.check(t, "%s operand %d" % (name, i), torch.int32, (A,), device)
    for i, t in enumerate(floats):
        _build.check(t, "%s float operand %d" % (name, i), torch.float32,
                     (A,), device)
    _build.check(sort_y, "%s sort_y" % name, torch.int32, (A,), device)
    _, P, start, overflow = plan or _seg_plan(sort_y, margin, seg_win)
    _build.check(start, "%s plan start" % name, torch.int32,
                 (_ceil_to(A, SEG_ROWS) // SEG_ROWS,), device)
    _build.check(overflow, "%s plan overflow" % name, torch.bool, (), device)
    return A, device, P, start, overflow


def rect_first_overlap_seg_ref(qx, qy, tbw, tbh, x, y, bw, bh, sort_y, order,
                               *, max_body, gate, margin, seg_win=None,
                               plan=None):
    """Plain version (the JAX package's ``rect_first_overlap_seg``): pad,
    plan, gather the [S, P] body windows, sweep each segment's queries
    against its window with the slot ids of ``order``; when the plan
    overflows, the full sweep with explicit slot ids instead."""
    A = qx.shape[0]
    stride = _rect_stride(A, max_body, gate)
    Ap = _ceil_to(A, SEG_ROWS)
    qx_p, qy_p, tbw_p, tbh_p, x_p, y_p, bw_p, bh_p, ord_p = (
        _pad_operands_to(Ap, [
            (qx, RECT_PAD), (qy, RECT_PAD), (tbw, 0), (tbh, 0), (x, 0),
            (y, 0), (bw, 0), (bh, 0), (order, RECT_NONE - 1)]))
    S, P, start, overflow = plan or _seg_plan(sort_y, margin, seg_win)
    if bool(overflow):
        return _rect_overlap_pairs((qx, qy, tbw, tbh, order),
                                   (x, y, bw, bh, order), max_body, gate,
                                   stride)
    wins = _seg_gather((x_p, y_p, bw_p, bh_p, ord_p), start, P)
    segs = [op.reshape(S, SEG_ROWS) for op in (qx_p, qy_p, tbw_p, tbh_p,
                                                ord_p)]
    return _rect_overlap_pairs(segs, wins, max_body, gate,
                               stride).reshape(Ap)[:A]


def rect_first_overlap_seg(qx, qy, tbw, tbh, x, y, bw, bh, sort_y, order, *,
                           max_body, gate, margin, seg_win=None, plan=None):
    """:func:`rect_first_overlap` of one big world, y-segmented: [A] int32
    operands sorted by y (``sort_y`` non-decreasing, ``order[i]`` the
    original slot of sorted row i), results in sorted-row order carrying
    the original slot ids, so they equal the slot-ordered sweep's.
    ``plan``: ``_seg_plan(sort_y, margin, seg_win)``, made once by a caller
    whose sweeps share a sort and a margin (the step plans once per margin);
    else the call makes it.

    Replaces ``magent_tpu/ops/attack_prefix.py:814``
    ``rect_first_overlap_seg`` and its core ``_rect_overlap_core`` (``:678``,
    ``pallas_call`` at ``:735``); the overflow branch, there
    ``rect_first_overlap_tpu`` with ``qslot``/``bslot``, is the same kernel
    sweeping every row.  Bound on the card: 12 integer instructions per
    pair over A * P pairs (pursuit at map 1000: 37 segments x 1024 x 2560,
    97.0 M pairs per gate).  Design: ``csrc/seg_kernels.cu`` — one thread
    per sorted query row, ``blockIdx.x`` a 128-row tile of a segment; the
    block stages 128 window rows at a time in shared memory and reads its
    window in place as ``[start_s, start_s + P)`` of the sorted operands,
    with ``start`` and ``overflow`` read on the device, so the plan costs
    no host sync and no [S, P] gather.  Rows past A are the pad sentinels
    (empty rects), skipped, so the operands are not padded in memory.  The
    gates compare slot ids, so ``lower_only`` has no triangular skip.
    Ints: equal to the plain version exactly."""
    ints = (qx, qy, tbw, tbh, x, y, bw, bh, order)
    stride = _rect_stride(qx.shape[0], max_body, gate)
    if _build.route(*ints, sort_y) == "cpu":
        return rect_first_overlap_seg_ref(
            qx, qy, tbw, tbh, x, y, bw, bh, sort_y, order, max_body=max_body,
            gate=gate, margin=margin, seg_win=seg_win, plan=plan)
    A, device, P, start, overflow = _seg_launch_operands(
        "rect_first_overlap_seg", ints, (), sort_y, margin, seg_win, plan)
    out = torch.empty((A,), dtype=torch.int32, device=device)
    if A:
        _build.launch("magent_rect_first_overlap_seg", device,
                      *(t.data_ptr() for t in ints), start.data_ptr(),
                      overflow.data_ptr(), A, P, stride, int(max_body),
                      int(gate == "lower_only"), out.data_ptr())
    return out


def occupant_rect_seg_ref(qx, qy, x, y, bw, bh, hp, sort_y, order, *, margin,
                          seg_win=None, plan=None):
    """Plain version (the JAX package's ``occupant_rect_seg``): as
    :func:`rect_first_overlap_seg_ref`, the bodies carrying the slot ids of
    ``order``."""
    A = qx.shape[0]
    Ap = _ceil_to(A, SEG_ROWS)
    qx_p, qy_p, x_p, y_p, bw_p, bh_p, hp_p, ord_p = _pad_operands_to(
        Ap, [(qx, RECT_PAD), (qy, RECT_PAD), (x, 0), (y, 0), (bw, 0),
             (bh, 0), (hp, 0.0), (order, -1)])
    S, P, start, overflow = plan or _seg_plan(sort_y, margin, seg_win)
    if bool(overflow):
        return _occupant_rect_pairs(qx, qy, x, y, bw, bh, hp, order)
    wins = _seg_gather((x_p, y_p, bw_p, bh_p, hp_p, ord_p), start, P)
    tgt, hp_t = _occupant_rect_pairs(qx_p.reshape(S, SEG_ROWS),
                                     qy_p.reshape(S, SEG_ROWS), *wins)
    return tgt.reshape(Ap)[:A], hp_t.reshape(Ap)[:A]


def occupant_rect_seg(qx, qy, x, y, bw, bh, hp, sort_y, order, *, margin,
                      seg_win=None, plan=None):
    """:func:`occupant_rect` of one big world, y-segmented (no
    ``exclude_self``: the attack never targets itself): operands sorted
    by y and ``plan`` as in :func:`rect_first_overlap_seg` -> (tgt [A]
    int32 original slot or -1, hp_t [A] f32), in sorted-row order.

    Replaces ``magent_tpu/ops/attack_prefix.py:915`` ``occupant_rect_seg``
    and its core ``_occupant_rect_core`` (``:864``, ``pallas_call`` at
    ``:901``); the overflow branch, there ``occupant_rect_tpu`` with
    ``bslot``, is the same kernel sweeping every row.  Bound on the card:
    4 integer instructions (four edge compares) per pair over A * P pairs
    (map 1000: 97.0 M), and a max of the slot id and an f32 add per
    matching pair.  Design: ``csrc/pair_kernels.cu`` on the split template
    of :func:`occupant_rect` — 4 sorted query rows per thread against
    window rows staged as their edges (one int4) and (slot id, hp bits)
    (one int2), a warp updating its queries only where one of its lanes
    matched; each 128-row tile's window, ``[start_s, start_s + P)`` or
    every row when the plan overflows (both read on the device: no host
    sync, no [S, P] gather), cut over the warps of a thread-block cluster
    (:func:`seg_split`, :func:`seg_bounds`), the partials folded in range
    order through distributed shared memory.  The window is not in slot
    order, so the kernel keeps the max slot id, not the last match.  Ints
    equal the plain version exactly; ``hp_t`` bit for bit wherever a query
    matches at most two bodies (the engine's bodies never overlap, so at
    most one), else within rounding (the sum runs in window order)."""
    ints = (qx, qy, x, y, bw, bh, order)
    if _build.route(*ints, hp, sort_y) == "cpu":
        return occupant_rect_seg_ref(qx, qy, x, y, bw, bh, hp, sort_y, order,
                                     margin=margin, seg_win=seg_win, plan=plan)
    A, device, P, start, overflow = _seg_launch_operands(
        "occupant_rect_seg", ints, (hp,), sort_y, margin, seg_win, plan)
    return _occupant_rect_seg_launch(ints, hp, P, start, overflow,
                                     _seg_split_on(device, A, P))


def _occupant_rect_seg_launch(ints, hp, P, start, overflow, split):
    """Launch the occupant_rect_seg kernel on validated operands ``ints =
    (qx, qy, x, y, bw, bh, order)`` and ``hp`` with the plan's window width
    ``P``, ``start`` and ``overflow``, and ``split = (cluster, warps)``."""
    A = hp.shape[0]
    tgt = torch.empty((A,), dtype=torch.int32, device=hp.device)
    hp_t = torch.empty((A,), dtype=torch.float32, device=hp.device)
    if A:
        _build.launch("magent_occupant_rect_seg", hp.device,
                      *(t.data_ptr() for t in ints[:6]), hp.data_ptr(),
                      ints[6].data_ptr(), start.data_ptr(),
                      overflow.data_ptr(), A, P, *split, tgt.data_ptr(),
                      hp_t.data_ptr())
    return tgt, hp_t


def rank_prefix_seg_ref(tgt, rank, dmg, sort_y, *, margin, seg_win=None,
                        plan=None):
    """Plain version (the JAX package's ``rank_prefix_seg``): positional
    (the rank keys carry the slot tie-break); the full sweep
    :func:`rank_prefix_ref` when the plan overflows."""
    A = tgt.shape[0]
    Ap = _ceil_to(A, SEG_ROWS)
    tgt_p, rank_p, dmg_p = _pad_operands_to(
        Ap, [(tgt, QUERY_NONE), (rank, 0), (dmg, 0.0)])
    S, P, start, overflow = plan or _seg_plan(sort_y, margin, seg_win)
    if bool(overflow):
        return rank_prefix_ref(tgt, rank, dmg)
    wins = _seg_gather((tgt_p, rank_p, dmg_p), start, P)
    out = _rank_pairs(tgt_p.reshape(S, SEG_ROWS),
                      rank_p.reshape(S, SEG_ROWS), *wins)
    return out.reshape(Ap)[:A]


def rank_prefix_seg(tgt, rank, dmg, sort_y, *, margin, seg_win=None,
                    plan=None):
    """:func:`rank_prefix` of one big world, y-segmented: [A] operands in
    y-sorted order (``tgt`` int32 target slot, ``rank`` int32
    :func:`pack_rank` keys, ``dmg`` f32), ``margin`` = 2 * (attack y-reach
    + max body), ``plan`` as in :func:`rect_first_overlap_seg` -> P [A]
    f32 in sorted-row order.

    Replaces ``magent_tpu/ops/attack_prefix.py:983`` ``rank_prefix_seg``
    and its core ``_rank_prefix_core`` (``:945``, ``pallas_call`` at
    ``:971``); the overflow branch, there ``rank_prefix_tpu``, is the same
    kernel sweeping every row.  Bound on the card: 2 integer instructions
    (two compares) and one f32 add per pair over A * P pairs (map 1000:
    135.8 M).  Design: ``csrc/pair_kernels.cu``, :func:`rank_prefix`'s
    sweep on each tile's window as in :func:`occupant_rect_seg`
    (:func:`seg_split`, :func:`seg_bounds`).  The kernel sums in window
    order within a range, then range by range (deterministic for a given
    split), the plain version in its reduction order: equal when the
    damages are integer-valued (pursuit's), else within 1e-5."""
    if _build.route(tgt, rank, dmg, sort_y) == "cpu":
        return rank_prefix_seg_ref(tgt, rank, dmg, sort_y, margin=margin,
                                   seg_win=seg_win, plan=plan)
    A, device, P, start, overflow = _seg_launch_operands(
        "rank_prefix_seg", (tgt, rank), (dmg,), sort_y, margin, seg_win, plan)
    return _rank_prefix_seg_launch(tgt, rank, dmg, P, start, overflow,
                                   _seg_split_on(device, A, P))


def _rank_prefix_seg_launch(tgt, rank, dmg, P, start, overflow, split):
    """Launch the rank_prefix_seg kernel on validated operands with the
    plan's window width ``P``, ``start`` and ``overflow``, and ``split =
    (cluster, warps)``."""
    A = tgt.shape[0]
    out = torch.empty((A,), dtype=torch.float32, device=tgt.device)
    if A:
        _build.launch("magent_rank_prefix_seg", tgt.device, tgt.data_ptr(),
                      rank.data_ptr(), dmg.data_ptr(), start.data_ptr(),
                      overflow.data_ptr(), A, P, *split, out.data_ptr())
    return out
