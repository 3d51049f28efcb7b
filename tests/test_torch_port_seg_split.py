"""The segmented sweeps' launch split, on the CPU: ``seg_split`` (cluster
and warps per CTA) and ``seg_bounds``, the Python twin of ``seg_range`` in
``magent_tpu_torch/csrc/pair_kernels.cu``, which cuts each 128-row query
tile's window of sorted rows into one contiguous range per warp of a
thread-block cluster.

Every window row must fall in exactly one range of every query tile, in
both plan forms (the window ``[start, min(A, start + P))`` and the
overflow form ``[0, A)``), and the plain partials over those ranges,
combined in range order as the cluster's rank-0 CTA combines them (max
slot id and summed hp; summed damage), must equal the JAX package's
``occupant_rect_seg`` and ``rank_prefix_seg`` with their Pallas cores in
interpret mode, on the seeded operands of tests/_torch_seg_operands.py.
The CUDA kernels themselves are held against their plain versions on the
card (tests/test_torch_port_gpu.py, chip_smoke.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.ops import attack_prefix as jap

from magent_tpu_torch.ops import attack_prefix as tap
from magent_tpu_torch.tools.profile_rect import SPLITS

from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_seg_operands import CASES, occupant_case, rank_case, t as _t

# the folds' thousands of mid-sized reductions (see one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

H100_SMS = 132
# ragged sorted row counts: around the 128-row tile and the 1024-row
# segment, pursuit's one world at map 662 (the smallest on the segmented
# route) and at map 1000
SEG_A = (1, 127, 129, 1023, 1025, 16434, 37500)
# the path's windows: margin 4 (the occupant and the move sweeps) and 8
# (the rank sweep) at maps 662 and 1000 (core/engine.py _seg_win_hint)
PATH_P = {(16434, 4): 2560, (16434, 8): 3072, (37500, 4): 2560,
          (37500, 8): 3584}


def _plan(A, form):
    """A plan of A sorted rows with y uniform over A / 37.5 rows (pursuit's
    density at map 1000), margin 4, the engine's window: ``"window"`` as
    planned (it does not overflow), ``"overflow"`` with its flag set."""
    rng = np.random.RandomState(A)
    sort_y = np.sort(rng.randint(0, max(1, int(A / 37.5)), A)).astype(
        np.int32)
    seg_win = tap.SEG_ROWS + 6 * 4 * 38 + 512
    S, P, start, overflow = tap._seg_plan(_t(sort_y), 4, seg_win)
    assert not bool(overflow)
    return S, P, start.numpy(), form == "overflow"


@pytest.mark.parametrize("A", SEG_A)
@pytest.mark.parametrize("form", ["window", "overflow"])
@pytest.mark.parametrize("split", SPLITS)
def test_seg_ranges_cover_every_window_row_once(A, form, split):
    S, P, start, overflow = _plan(A, form)
    cluster, warps = split
    n = cluster * warps
    clamped = 0
    for t in range(-(-A // tap.RECT_TILE)):
        b = tap.seg_bounds(t, n, A, P, start, overflow)
        assert len(b) == n + 1  # every warp of the cluster takes part
        if overflow:
            begin, end = 0, A
            assert b == tap.rect_bounds(t, n, A, False)
        else:
            begin = int(start[t // tap.SEG_TILES])
            end = min(A, begin + P)
            clamped += begin + P > A
            # the tile's rows lie in its window
            t0 = t * tap.RECT_TILE
            assert begin <= t0 and min(A, t0 + tap.RECT_TILE) <= end
        assert b[0] == begin and b[-1] == end
        held = np.zeros(A, np.int64)
        for lo, hi in zip(b[:-1], b[1:]):
            assert lo <= hi
            held[lo:hi] += 1
        assert (held[begin:end] == 1).all()
        assert held.sum() == end - begin
        sizes = np.diff(b)
        assert sizes.max() - sizes.min() <= 1  # equal rows, to one
    # the last segment's window is cut at A wherever A is ragged
    assert overflow or clamped or A % tap.SEG_ROWS == 0


@pytest.mark.parametrize("A,P,want", [
    (16434, 2560, (8, 4)), (16434, 3072, (8, 4)), (37500, 2560, (8, 4)),
    (37500, 3584, (8, 4)), (3072, 2048, (8, 4)), (1, 1024, (8, 4)),
    (1, 256, (2, 4))])
def test_seg_split_fills_the_card(A, P, want):
    """Pursuit's one world at map 662 (129 query tiles) and at map 1000
    (293), each with its occupant window (margin 4) and its rank window
    (margin 8), on the H100's 132 SMs: clusters of 8 CTAs of 4 warps, the
    fastest split measured there (PERF.md §6); the random operands'
    3072 rows; a window too short for 8 CTAs keeps 32 rows per warp."""
    if A in (16434, 37500):
        assert PATH_P[(A, 4 if P == 2560 else 8)] == P
    assert tap.seg_split(A, P, H100_SMS) == want


def test_seg_split_checks_its_slots():
    with pytest.raises(ValueError, match="at most"):
        tap.seg_split(tap.RECT_MAX_SLOTS + 1, 2560, H100_SMS)


def _ranges(A, plan, split):
    S, P, start, overflow = plan
    n = split[0] * split[1]
    for t in range(-(-A // tap.RECT_TILE)):
        q = slice(t * tap.RECT_TILE, min(A, (t + 1) * tap.RECT_TILE))
        b = tap.seg_bounds(t, n, A, P, start.numpy(), bool(overflow))
        yield q, [slice(lo, hi) for lo, hi in zip(b[:-1], b[1:]) if lo < hi]


@pytest.fixture(scope="module", autouse=True)
def _free_row_partials():
    yield
    _occupant_rows.cache_clear()
    _rank_rows.cache_clear()


@functools.lru_cache(maxsize=None)
def _occupant_rows(case):
    """Per query tile of the case's plan: each window row's own partial
    (slot id or -1, hp) against the tile's queries, ``[W, tile]``, from one
    call of the plain pair function with every row a partner set of its
    own; every split's ranges fold slices of it."""
    args, sort_y, order, margin = occupant_case(case)
    qx, qy, x, y, bw, bh, hp = (_t(a) for a in args)
    order_t = _t(order)
    plan = tap._seg_plan(_t(sort_y), margin)
    rows = [tap._occupant_rect_pairs(
        qx[q], qy[q], *(a[w, None] for a in (x, y, bw, bh, hp, order_t)))
        for q, (w,) in _ranges(qx.shape[0], plan, (1, 1))]
    return plan, rows


@functools.lru_cache(maxsize=None)
def _rank_rows(case):
    """The same for the rank sweep: each window row's damage term."""
    args, sort_y, live, margin = rank_case(case)
    tgt, rank, dmg = (_t(a) for a in args)
    plan = tap._seg_plan(_t(sort_y), margin)
    rows = [tap._rank_pairs(tgt[q], rank[q], *(a[w, None]
                                                for a in (tgt, rank, dmg)))
            for q, (w,) in _ranges(tgt.shape[0], plan, (1, 1))]
    return plan, rows


@functools.lru_cache(maxsize=None)
def _jax_occupant(case):
    args, sort_y, order, margin = occupant_case(case)
    got = jap.occupant_rect_seg(*map(jnp.asarray, args), jnp.asarray(sort_y),
                                jnp.asarray(order), margin=margin,
                                interpret=True)
    return tuple(np.asarray(g) for g in got)


@functools.lru_cache(maxsize=None)
def _jax_rank(case):
    args, sort_y, _, margin = rank_case(case)
    return np.asarray(jap.rank_prefix_seg(
        *map(jnp.asarray, args), jnp.asarray(sort_y), margin=margin,
        interpret=True))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("split", SPLITS)
def test_combined_occupant_seg_partials_match_jax(case, split):
    """Max slot id exact; hp exact on every query with at most two matches
    (a + b = b + a), within 1e-6 on the degenerate case's piles of three
    or more (as tests/test_torch_port_seg_kernels.py holds the plain
    version)."""
    args, _, _, _ = occupant_case(case)
    qx, qy, x, y, bw, bh, hp = (_t(a) for a in args)
    A = qx.shape[0]
    plan, rows = _occupant_rows(case)
    tgt = torch.full((A,), -2, dtype=torch.int32)
    hp_t = torch.full((A,), -1.0)
    for (q, ranges), (w,), (row_t, row_h) in zip(
            _ranges(A, plan, split), (r for _, r in _ranges(A, plan, (1, 1))),
            rows):
        best = torch.full((q.stop - q.start,), -1, dtype=torch.int32)
        hsum = torch.zeros(q.stop - q.start)
        for b in ranges:
            b = slice(b.start - w.start, b.stop - w.start)
            best = torch.maximum(best, row_t[b].amax(0))
            hsum = hsum + row_h[b].sum(0)
        tgt[q], hp_t[q] = best, hsum
    want_t, want_h = _jax_occupant(case)
    np.testing.assert_array_equal(tgt.numpy(), want_t)
    m = ((qx[None, :] >= x[:, None]) & (qx[None, :] < (x + bw)[:, None])
         & (qy[None, :] >= y[:, None]) & (qy[None, :] < (y + bh)[:, None]))
    few = (m.sum(0) <= 2).numpy()
    np.testing.assert_array_equal(hp_t.numpy()[few], want_h[few])
    np.testing.assert_allclose(hp_t.numpy(), want_h, atol=1e-6, rtol=0)
    assert (m.sum(0) == 2).any() and (want_t >= 0).sum() > A // 32


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("split", SPLITS)
def test_combined_rank_seg_partials_match_jax(case, split):
    """Damage summed range by range, within 1e-5 of the Pallas core on the
    live rows (sentinel rows sum window-dependent terms that the engine
    masks), as tests/test_torch_port_seg_kernels.py holds the plain
    version."""
    args, _, live, _ = rank_case(case)
    A = args[0].shape[0]
    plan, rows = _rank_rows(case)
    got = torch.full((A,), float("nan"))
    for (q, ranges), (w,), row_p in zip(
            _ranges(A, plan, split), (r for _, r in _ranges(A, plan, (1, 1))),
            rows):
        p = torch.zeros(q.stop - q.start)
        for b in ranges:
            p = p + row_p[b.start - w.start:b.stop - w.start].sum(0)
        got[q] = p
    want = _jax_rank(case)
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=1e-5,
                               rtol=0)
    assert (want[live] > 0).sum() > A // 8
