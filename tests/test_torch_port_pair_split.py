"""The one-cell sweeps on the split template, on the CPU: ``occupant`` and
``move_claims`` (``magent_tpu_torch/csrc/pair_kernels.cu``) cut each
128-query tile's partner axis into ``cluster * warps`` ranges with
``rect_range``, whose Python twin is ``rect_bounds``: every partner once
for the occupant (no gate), the partners below the tile's last slot for
``move_claims`` (the pairs i < j alone: a slot always matches itself, so
the lowest matching slot is j or lower).

Every pair must fall in exactly one range, ``rect_split`` must pick the
launch splits of battle's lockstep step (B=16, A=2000) and the
GridWorld's (B=1, A=2048), and the plain partials over the ranges, folded
in range order as the cluster folds them — (count, slot sum, hp sum) by
three adds; (cnt, head) by an add and a min, head starting at j — must
equal the JAX package: ``occupant_tpu`` and ``move_claims_tpu`` in
interpret mode on unique cells, ``occupant_xla`` and ``move_claims_xla``
on duplicate cells and a shared sentinel; ints exactly, the occupant's hp
bit for bit wherever a query matches at most two slots, else within
1e-5.  The CUDA kernels themselves are held against their plain versions
on the card (tests/test_torch_port_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.ops import attack_prefix as jap

from magent_tpu_torch.ops import attack_prefix as tap
from magent_tpu_torch.tools import profile_rect as tpr

from _torch_port_cases import one_torch_thread  # noqa: F401

# the folds' thousands of mid-sized reductions (see one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

H100_SMS = 132
# around the 128-slot query tile, a ragged middle, battle's 2000 slots and
# the GridWorld's 2048
PAIR_A = (1, 2, 127, 128, 129, 777, 2000, 2048)
B = 2
# f32 hp sums of piles of three or more slots, in another order than the
# reference's
PAIR_ATOL = 1e-5
# the grid path's shared non-mover cell: H * W of a map-125 world
SENTINEL = 125 * 125


def _ranges(t, n, A, lower_only):
    b = tap.rect_bounds(t, n, A, lower_only)
    return list(zip(b[:-1], b[1:]))


def _tiles(A):
    for t in range(-(-A // tap.RECT_TILE)):
        yield t, slice(t * tap.RECT_TILE, min(A, (t + 1) * tap.RECT_TILE))


@pytest.mark.parametrize("A", PAIR_A)
@pytest.mark.parametrize("n_envs", [1, 16])
@pytest.mark.parametrize("kernel", ["occupant", "move_claims"])
def test_ranges_cover_every_pair_once(A, n_envs, kernel):
    """The occupant's ranges cut [0, A) into cluster * warps ranges of
    equal slots (to one); move_claims' cut [0, t1 - 1), and the pairs i < j
    of the tile's queries each lie in exactly one range."""
    lower = kernel == "move_claims"
    cluster, warps = tap.rect_split(n_envs, A, H100_SMS)
    n = cluster * warps
    for t, q in _tiles(A):
        ranges = _ranges(t, n, A, lower)
        assert len(ranges) == n
        assert ranges[0][0] == 0
        assert ranges[-1][1] == (q.stop - 1 if lower else A)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert max(hi - lo for lo, hi in ranges) - min(
            hi - lo for lo, hi in ranges) <= 1
        held = np.zeros(A, np.int64)
        for lo, hi in ranges:
            held[lo:hi] += 1
        if lower:
            # pairs (i, j), i < j, j a query of the tile: each held once
            i = np.arange(A)[:, None]
            j = np.arange(q.start, q.stop)[None, :]
            need = (i < j).any(1)
            assert (held[need] == 1).all() and (held[~need] == 0).all()
        else:
            assert (held == 1).all()


@pytest.mark.parametrize("B_,A,want", [(16, 2000, (1, 8)),
                                       (1, 2048, (8, 8))])
def test_rect_split_picks(B_, A, want):
    """Battle's lockstep occupant (B=16, A=2000): 256 lone CTAs of 8
    warps, rank_prefix's split there; the GridWorld's move_claims (B=1,
    A=2048): clusters of 8 CTAs of 8 warps, 128 CTAs where the one-thread-
    per-query design launched 16 blocks."""
    assert tap.rect_split(B_, A, H100_SMS) == want


def _fold_occupant(acell, cell, hp, splits):
    """The occupant's plain partials over each tile's ranges, folded in
    range order, for every split: (count, slot sum, hp sum) by three adds.
    Each tile's [B, A, tile] match terms are built once and every split's
    ranges slice them."""
    Bn, A = acell.shape
    slots = torch.arange(A)
    out = [(torch.full((Bn, A), -2, dtype=torch.int32),
            torch.full((Bn, A), float("nan"))) for _ in splits]
    for t, q in _tiles(A):
        m = cell[:, :, None] == acell[:, None, q]  # [B, A, tile]
        # (match, slot) per pair, and its hp
        ints = torch.stack([m.long(), m * slots[:, None]], -1)
        hps = m * hp[:, :, None]
        for (tgt, hp_t), split in zip(out, splits):
            acc = torch.zeros((Bn, q.stop - q.start, 2), dtype=torch.int64)
            hsum = torch.zeros((Bn, q.stop - q.start))
            for lo, hi in _ranges(t, split[0] * split[1], A, False):
                acc = acc + ints[:, lo:hi].sum(1)
                hsum = hsum + hps[:, lo:hi].sum(1)
            cnt, ssum = acc.unbind(-1)
            tgt[:, q] = torch.where(cnt > 0, ssum, -1).to(torch.int32)
            hp_t[:, q] = hsum
    return out


def _fold_claims(tcell, splits):
    """move_claims' plain partials over each tile's lower ranges, the i < j
    gate on every pair, folded in range order for every split: (cnt, head)
    by an add and a min, head starting at j.  Each tile's [B, A, tile]
    gated match mask is built once and every split's ranges slice it."""
    Bn, A = tcell.shape
    slots = torch.arange(A)
    out = [(torch.full((Bn, A), -2, dtype=torch.int32),
            torch.full((Bn, A), -2, dtype=torch.int32)) for _ in splits]
    for t, q in _tiles(A):
        m = (tcell[:, :, None] == tcell[:, None, q]) & (
            slots[:, None] < slots[None, q])
        heads = torch.where(m, slots[:, None], A)
        for (cnt_out, head_out), split in zip(out, splits):
            cnt = torch.zeros((Bn, q.stop - q.start), dtype=torch.int64)
            head = slots[q].expand(Bn, -1).clone()
            for lo, hi in _ranges(t, split[0] * split[1], A, True):
                if hi == lo:  # the identity: the kernel folds it all the same
                    continue
                cnt = cnt + m[:, lo:hi].sum(1)
                head = torch.minimum(head, heads[:, lo:hi].amin(1))
            cnt_out[:, q], head_out[:, q] = cnt.to(torch.int32), head.to(
                torch.int32)
    return out


def _assert_hp(got, want, matches, tag):
    """Bit for bit wherever a query matches at most two slots, else within
    PAIR_ATOL."""
    want = torch.from_numpy(np.array(want))
    few = matches <= 2
    assert torch.equal(got[few], want[few]), tag
    torch.testing.assert_close(got[~few], want[~few], atol=PAIR_ATOL, rtol=0)


@pytest.mark.parametrize("A", PAIR_A)
@pytest.mark.parametrize("duplicates", [False, True])
def test_combined_occupant_partials_match_jax(A, duplicates):
    """In every split of tools/profile_rect.py's table and the one
    rect_split picks: against occupant_tpu in interpret mode (unique
    cells) or occupant_xla (duplicate cells)."""
    acell, cell, hp = tpr.cell_operands(A, B, 5 * A + duplicates,
                                        duplicates)
    ref = jax.jit(jax.vmap(jap.occupant_xla)) if duplicates else jax.vmap(
        lambda a, c, h: jap.occupant_tpu(a, c, h, interpret=True))
    want_t, want_h = ref(*(jnp.asarray(t.numpy()) for t in (acell, cell,
                                                             hp)))
    matches = tpr.occupant_matches(acell, cell)
    splits = tpr.SPLITS + [tap.rect_split(B, A, H100_SMS)]
    for split, (tgt, hp_t) in zip(splits, _fold_occupant(acell, cell, hp,
                                                         splits)):
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(want_t),
                                      err_msg=str(split))
        _assert_hp(hp_t, want_h, matches, split)
    if A >= 127:
        assert int((tgt >= 0).sum()) > A // 4
        assert (int((matches > 2).sum()) > 0) == duplicates


@pytest.mark.parametrize("A", PAIR_A)
@pytest.mark.parametrize("operands", ["unique", "shared sentinel"])
def test_combined_move_claims_partials_match_jax(A, operands):
    """In every split of tools/profile_rect.py's table and the one
    rect_split picks: against move_claims_tpu in interpret mode (unique
    target cells) or move_claims_xla (contended targets, a third of the
    slots at one shared sentinel)."""
    if operands == "unique":
        rng = np.random.RandomState(A)
        tcell = torch.from_numpy(np.stack([
            rng.permutation(3 * A)[:A] for _ in range(B)]).astype(np.int32))
        ref = jax.vmap(lambda t: jap.move_claims_tpu(t, interpret=True))
    else:
        tcell = tpr.claim_operands(A, B, 7 * A, SENTINEL)
        ref = jax.jit(jax.vmap(jap.move_claims_xla))
    want_c, want_h = (np.asarray(w) for w in ref(jnp.asarray(tcell.numpy())))
    splits = tpr.SPLITS + [tap.rect_split(B, A, H100_SMS)]
    for split, (cnt, head) in zip(splits, _fold_claims(tcell, splits)):
        np.testing.assert_array_equal(cnt.numpy(), want_c, err_msg=str(split))
        np.testing.assert_array_equal(head.numpy(), want_h,
                                      err_msg=str(split))
    if operands == "shared sentinel" and A >= 127:
        assert int((cnt > 0).sum()) > A // 2
