"""The rect sweeps' launch split, on the CPU: ``rect_split`` (cluster and
warps per CTA) and ``rect_bounds``, the Python twin of ``rect_range`` in
``magent_tpu_torch/csrc/pair_kernels.cu``, which cuts each query tile's
body axis into one contiguous range per warp of a thread-block cluster.

Every gated pair (i, j) must fall in exactly one range, and the plain
partials over those ranges, combined in range order as the cluster's
rank-0 CTA combines them (max slot and summed hp; min key), must equal the
Pallas kernels in interpret mode bit for bit, on the seeded operands of
tests/test_torch_port_rect_kernels.py.  The CUDA kernels themselves are
held against their plain versions on the card
(tests/test_torch_port_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.ops import attack_prefix as jap

from magent_tpu_torch.ops import attack_prefix as tap
from magent_tpu_torch.tools.profile_rect import RAGGED_A, rank_operands

from test_torch_port_rect_kernels import B, CASES, _bodies, _moved_rects, _t

H100_SMS = 132
# rank_prefix's sizes: around the 128-slot query tile, pursuit's map-64
# capacity, battle's 2000 slots, GridWorld's 2048, the map-500 world and
# the single-world pair sweeps' largest
RANK_A = (1, 2, 127, 128, 129, 153, 2000, 2048, 9375, 16384)
# f32 pair sums in another order than the Pallas kernel's
PAIR_ATOL = 1e-5
# splits beside the one rect_split picks: one range per tile, the most
# ranges a launch takes, and a cluster that is not a power of two
SPLITS = [None, (1, 1), (8, 8), (3, 5)]


def _ranges(t, n, A, lower_only):
    b = tap.rect_bounds(t, n, A, lower_only)
    return list(zip(b[:-1], b[1:]))


def _gated(t, A, lower_only):
    """[P, Q] bool: body i has a gated pair with query t0 + q of tile t."""
    t0 = t * tap.RECT_TILE
    j = np.arange(t0, min(A, t0 + tap.RECT_TILE))
    i = np.arange(A)[:, None]
    return i < j if lower_only else i != j


@pytest.mark.parametrize("A", RAGGED_A)
@pytest.mark.parametrize("n_envs", [1, 16])
@pytest.mark.parametrize("gate", ["exclude_self", "lower_only"])
def test_ranges_cover_every_gated_pair_once(A, n_envs, gate):
    lower = gate == "lower_only"
    cluster, warps = tap.rect_split(n_envs, A, H100_SMS)
    assert 1 <= cluster <= tap.RECT_MAX_CLUSTER and warps == tap.RECT_WARPS
    n = cluster * warps
    n_tiles = -(-A // tap.RECT_TILE)
    for t in range(n_tiles):
        ranges = _ranges(t, n, A, lower)
        assert len(ranges) == n  # every warp of the cluster takes part
        t1 = min(A, (t + 1) * tap.RECT_TILE)
        end = t1 - 1 if lower else A
        assert ranges[0][0] == 0 and ranges[-1][1] == end
        assert all(lo <= hi for lo, hi in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        # the gated pairs of each body, counted once per range holding it
        per_body = _gated(t, A, lower).sum(1)
        held = np.zeros(A, np.int64)
        pairs = []
        for lo, hi in ranges:
            held[lo:hi] += 1
            pairs.append(int(per_body[lo:hi].sum()))
        assert (held[per_body > 0] == 1).all()
        assert (held <= 1).all()
        # an empty range holds no pair, and the ranges hold every pair
        assert all(p == 0 for p, (lo, hi) in zip(pairs, ranges) if lo == hi)
        assert sum(pairs) == int(per_body.sum())
        # equal shares of the slots swept (to one)
        assert max(hi - lo for lo, hi in ranges) - min(
            hi - lo for lo, hi in ranges) <= 1


@pytest.mark.parametrize("A,n_envs,want", [
    (153, 16, 1), (9375, 1, 8), (16384, 1, 8), (1000, 16, 4), (1, 1, 1),
    (2000, 16, 1), (2048, 1, 8)])
def test_rect_split_fills_the_card(A, n_envs, want):
    """pursuit map 64 (A=153, B=16): lone CTAs (a cluster launch costs ~1
    us there); the map-500 world and the largest single world: clusters of
    8 (4.5 CTAs per SM); battle's rank_prefix (A=2000, B=16): lone CTAs,
    whose 256 already fill the card; the GridWorld's (A=2048, B=1): 8."""
    cluster, _ = tap.rect_split(n_envs, A, H100_SMS)
    assert cluster == want


def _split(A, split):
    return split or tap.rect_split(B, A, H100_SMS)


@pytest.mark.parametrize("A,MB", CASES)
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("split", SPLITS)
def test_combined_occupant_partials_match_jax(A, MB, exclude_self, split):
    rng, S, x, y, bw, bh = _bodies(A, MB, A + MB)
    hp = rng.uniform(0.1, 1.0, size=(B, A)).astype(np.float32)
    qx = rng.randint(0, S, size=(B, A)).astype(np.int32)
    qy = rng.randint(0, S, size=(B, A)).astype(np.int32)
    own = rng.uniform(size=(B, A)) < 0.25
    qx = np.where(own, x, qx).astype(np.int32)
    qy = np.where(own, y, qy).astype(np.int32)
    args = [_t(a) for a in (qx, qy, x, y, bw, bh, hp)]
    cluster, warps = _split(A, split)
    slots = torch.arange(A)
    tgt = torch.full((B, A), -2, dtype=torch.int32)
    hp_t = torch.full((B, A), -1.0)
    for t in range(-(-A // tap.RECT_TILE)):
        q = slice(t * tap.RECT_TILE, min(A, (t + 1) * tap.RECT_TILE))
        best = torch.full((B, q.stop - q.start), -1, dtype=torch.int32)
        hsum = torch.zeros((B, q.stop - q.start))
        for lo, hi in _ranges(t, cluster * warps, A, False):
            if lo == hi:  # the identity: the kernel combines it all the same
                continue
            b = slice(lo, hi)
            part_t, part_h = tap._occupant_rect_pairs(
                args[0][:, q], args[1][:, q], *(a[:, b] for a in args[2:]),
                slots[b], slots[q] if exclude_self else None)
            best = torch.maximum(best, part_t)
            hsum = hsum + part_h
        tgt[:, q], hp_t[:, q] = best, hsum
    for b in range(B):
        want_t, want_h = jap.occupant_rect_tpu(
            *(jnp.asarray(a[b]) for a in (qx, qy, x, y, bw, bh, hp)),
            exclude_self=exclude_self, interpret=True)
        np.testing.assert_array_equal(tgt[b].numpy(), np.asarray(want_t))
        np.testing.assert_array_equal(hp_t[b].numpy(), np.asarray(want_h))
    assert (tgt >= 0).sum() > A // 8


@pytest.mark.parametrize("A,MB", CASES)
@pytest.mark.parametrize("gate", ["exclude_self", "lower_only"])
@pytest.mark.parametrize("split", SPLITS)
def test_combined_overlap_partials_match_jax(A, MB, gate, split):
    rng, S, x, y, bw, bh = _bodies(A, MB, 7 * A + MB)
    qx, qy, tbw, tbh = _moved_rects(rng, x, y, bw, bh)
    lower = gate == "lower_only"
    arrs = (qx, qy, tbw, tbh) * 2 if lower else (qx, qy, tbw, tbh, x, y,
                                                  bw, bh)
    args = [_t(a) for a in arrs]
    cluster, warps = _split(A, split)
    stride = tap._rect_stride(A, MB, gate)
    slots = torch.arange(A)
    got = torch.full((B, A), -2, dtype=torch.int32)
    for t in range(-(-A // tap.RECT_TILE)):
        q = slice(t * tap.RECT_TILE, min(A, (t + 1) * tap.RECT_TILE))
        best = torch.full((B, q.stop - q.start), tap._NONE_KEY)
        for lo, hi in _ranges(t, cluster * warps, A, lower):
            if lo == hi:  # the identity: the kernel combines it all the same
                continue
            b = slice(lo, hi)
            part = tap._rect_overlap_keys(
                [a[:, q] for a in args[:4]] + [slots[q]],
                [a[:, b] for a in args[4:]] + [slots[b]], MB, gate, stride)
            best = torch.minimum(best, part)
        got[:, q] = torch.where(best == tap._NONE_KEY, tap.RECT_NONE,
                                best % stride).to(torch.int32)
    for b in range(B):
        want = jap.rect_first_overlap_tpu(
            *(jnp.asarray(a[b]) for a in arrs), max_body=MB, gate=gate,
            interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert (got < tap.RECT_NONE).sum() > A // 16


@pytest.mark.parametrize("A", RANK_A)
@pytest.mark.parametrize("n_envs", [1, 16])
def test_rank_prefix_ranges_cover_every_pair_once(A, n_envs):
    """rank_prefix's ranges (no gate): in every tile they cut [0, A) into
    cluster * warps contiguous ranges of equal slots (to one), so every
    pair (i, j) is swept once."""
    cluster, warps = tap.rect_split(n_envs, A, H100_SMS)
    n = cluster * warps
    for t in range(-(-A // tap.RECT_TILE)):
        ranges = _ranges(t, n, A, False)
        assert len(ranges) == n
        held = np.zeros(A, np.int64)
        for lo, hi in ranges:
            held[lo:hi] += 1
        assert (held == 1).all()
        assert ranges[0][0] == 0 and ranges[-1][1] == A
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert max(hi - lo for lo, hi in ranges) - min(
            hi - lo for lo, hi in ranges) <= 1


@pytest.mark.parametrize("A", [97, 300])
@pytest.mark.parametrize("damage", ["integer", "random"])
@pytest.mark.parametrize("split", SPLITS)
def test_combined_rank_prefix_partials_match_jax(A, damage, split):
    """The plain partials of rank_prefix over each tile's ranges, summed
    in range order, against rank_prefix_tpu in interpret mode (both
    forms): exact with integer damages, within PAIR_ATOL with random ones;
    hp_t, one direct load per query, exact."""
    tq, rq, dq, hq = rank_operands(A, B, A + len(damage),
                                   damage == "integer")
    tgt, rank, dmg, hp = (t.numpy() for t in (tq, rq, dq, hq))
    cluster, warps = _split(A, split)
    got = torch.full((B, A), float("nan"))
    for t in range(-(-A // tap.RECT_TILE)):
        q = slice(t * tap.RECT_TILE, min(A, (t + 1) * tap.RECT_TILE))
        p = torch.zeros((B, q.stop - q.start))
        for lo, hi in _ranges(t, cluster * warps, A, False):
            b = slice(lo, hi)
            p = p + tap._rank_pairs(tq[:, q], rq[:, q], tq[:, b], rq[:, b],
                                    dq[:, b])
        got[:, q] = p
    hp_t = torch.where((tq >= 0) & (tq < A), torch.gather(
        hq, 1, tq.clamp(0, A - 1).long()), 0.0)
    atol = 0.0 if damage == "integer" else PAIR_ATOL
    for b in range(B):
        args = [jnp.asarray(a[b]) for a in (tgt, rank, dmg)]
        want = np.asarray(jap.rank_prefix_tpu(*args, interpret=True))
        np.testing.assert_allclose(got[b].numpy(), want, atol=atol, rtol=0)
        want_p, want_hp = jap.rank_prefix_tpu(*args, jnp.asarray(hp[b]),
                                              interpret=True)
        np.testing.assert_array_equal(np.asarray(want_p), want)
        np.testing.assert_array_equal(hp_t[b].numpy(), np.asarray(want_hp))
    assert (got[:, :] > 0).sum() > A // 4
