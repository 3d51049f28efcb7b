"""Plain versions of the port's y-segmented pair sweeps and banded window
gather against the JAX package: ``rect_first_overlap_seg`` (both gates),
``occupant_rect_seg`` and ``rank_prefix_seg`` against the JAX functions with
their Pallas cores in interpret mode, the plan (``_seg_plan``) against the
JAX plan, and ``window_gather_banded`` against the Pallas kernel in
interpret mode.  The sweeps' inputs are made with numpy from a seed by
tests/_torch_seg_operands.py, as the generators of
tests/test_pairwise_kernels.py:99-243 make them: A = 3072 slots, three
segments of 1024, in two cases, y uniform over 400 rows (the windows
subset) and y in 3 rows (the windows overflow and the full sweep runs).
The port's wrappers take their plain versions on CPU tensors, so they are
held too; the CUDA kernels are held against the plain versions on the card
(tests/test_torch_port_gpu.py, chip_smoke.py).

Tolerances: ints exact; occupant hp atol 1e-6 (these random rects may
overlap, so a query can sum several hp in another order); rank sums atol
1e-5 on valid rows (sentinel rows sum window-dependent terms that the
engine masks); windows, dummy rows and ``inv`` exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.ops import attack_prefix as jap
from magent_tpu.ops import window_gather as jwg

from magent_tpu_torch.ops import attack_prefix as tap
from magent_tpu_torch.ops import window_gather as twg

from _torch_seg_operands import (A, CASES, MB, occupant_case, rank_case,
                                 rect_case, seg_calls, t as _t)


def _jax_plan(sort_y, margin, seg_win=None):
    n = sort_y.shape[0]
    Ap = jap._ceil_to(n, jap.SEG_ROWS)
    _, (y_s,) = jap._pad_operands_to(n, Ap, [(jnp.asarray(sort_y),
                                               jnp.int32(2**20))])
    S, P, start, overflow = jap._seg_plan(y_s, n, Ap, margin, seg_win)
    return S, P, np.asarray(start), bool(overflow)


def _port_plan(sort_y, margin, seg_win=None):
    S, P, start, overflow = tap._seg_plan(_t(sort_y), margin, seg_win)
    return S, P, start.numpy(), bool(overflow)


def _plan_case(case, n):
    """Sorted y of n rows; "boundary": three bands of rows (0-9, 100-109,
    108-112) where only the last, partial segment reaches far down."""
    rng = np.random.RandomState(n)
    if case == "boundary":
        y = np.concatenate([rng.randint(0, 10, 1024),
                            rng.randint(100, 110, 1024),
                            rng.randint(108, 113, n - 2048)])
    else:
        y = rng.randint(0, 3 if case == "degenerate" else 400, n)
    return np.sort(y).astype(np.int32)


@pytest.mark.parametrize("case,n,seg_win", [
    ("uniform", A, None), ("degenerate", A, None), ("uniform", 2500, None),
    ("boundary", 2500, 1536)])
def test_seg_plan_matches_jax(case, n, seg_win):
    """Same segments, window width and window starts.  Where A is a
    multiple of 1024 the overflow flag is the same too; past it the port
    reads the boundary segment's ymax from its last real row (ADVICE.md
    item 2), so its flag can only be clear where the JAX flag is set: the
    boundary case is such a plan (the JAX window of the last segment
    counts its 572 pad rows)."""
    sort_y = _plan_case(case, n)
    margin = MB + 4
    jS, jP, jstart, jover = _jax_plan(sort_y, margin, seg_win)
    S, P, start, over = _port_plan(sort_y, margin, seg_win)
    assert (S, P) == (jS, jP) == (-(-n // 1024),
                                  min(seg_win or 2048, S * 1024))
    np.testing.assert_array_equal(start, jstart)
    assert start.dtype == np.int32
    if n % tap.SEG_ROWS == 0:
        assert over == jover == (case == "degenerate")
    else:
        assert jover or not over
    if case == "boundary":
        assert jover and not over


def _check_overflow(sort_y, margin, case):
    assert _port_plan(sort_y, margin)[3] == (case == "degenerate")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("gate", ["exclude_self", "lower_only"])
def test_rect_first_overlap_seg_matches_jax(case, gate):
    args, sort_y, order = rect_case(case)
    margin = MB + 4
    _check_overflow(sort_y, margin, case)
    want = np.asarray(jap.rect_first_overlap_seg(
        *map(jnp.asarray, args), jnp.asarray(sort_y), jnp.asarray(order),
        max_body=MB, gate=gate, margin=margin, interpret=True))
    t_args = [_t(a) for a in args] + [_t(sort_y), _t(order)]
    for fn in (tap.rect_first_overlap_seg_ref, tap.rect_first_overlap_seg):
        got = fn(*t_args, max_body=MB, gate=gate, margin=margin)
        assert got.dtype == torch.int32 and got.shape == (A,)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)
    hit = want < tap.RECT_NONE
    assert hit.any() and not hit.all()
    if gate == "lower_only":
        assert (want[hit] < order[hit]).all()
    else:
        assert (want[hit] != order[hit]).all()


@pytest.mark.parametrize("case", CASES)
def test_occupant_rect_seg_matches_jax(case):
    args, sort_y, order, margin = occupant_case(case)
    _check_overflow(sort_y, margin, case)
    want_t, want_h = jap.occupant_rect_seg(
        *map(jnp.asarray, args), jnp.asarray(sort_y), jnp.asarray(order),
        margin=margin, interpret=True)
    t_args = [_t(a) for a in args] + [_t(sort_y), _t(order)]
    for fn in (tap.occupant_rect_seg_ref, tap.occupant_rect_seg):
        tgt, hp_t = fn(*t_args, margin=margin)
        assert tgt.dtype == torch.int32 and hp_t.dtype == torch.float32
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(hp_t.numpy(), np.asarray(want_h), atol=1e-6,
                                   rtol=0)
    assert (np.asarray(want_t) >= 0).any()


@pytest.mark.parametrize("case", CASES)
def test_rank_prefix_seg_matches_jax(case):
    args, sort_y, live, margin = rank_case(case)
    _check_overflow(sort_y, margin, case)
    want = np.asarray(jap.rank_prefix_seg(
        *map(jnp.asarray, args), jnp.asarray(sort_y), margin=margin,
        interpret=True))
    assert live.sum() > 100
    for fn in (tap.rank_prefix_seg_ref, tap.rank_prefix_seg):
        got = fn(*[_t(a) for a in args], _t(sort_y), margin=margin)
        assert got.dtype == torch.float32 and got.shape == (A,)
        np.testing.assert_allclose(got.numpy()[live], want[live], atol=1e-5,
                                   rtol=0)


def test_seg_checks_its_static_arguments():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="gate"):
        tap.rect_first_overlap_seg(*(z,) * 10, max_body=2, gate="upper",
                                   margin=4)


@pytest.mark.parametrize("seg_win", [None, 512])
def test_seg_sweeps_take_a_shared_plan(seg_win):
    """A plan made once by the caller (the step makes one per margin) gives
    what the sweep's own plan gives; a window narrower than a segment
    overflows, so the plan passed is the one the sweep runs on."""
    for name, fn, _, args, kw in seg_calls("uniform"):
        sort_y = args[-1] if name == "rank_prefix_seg" else args[-2]
        plan = tap._seg_plan(sort_y, kw["margin"], seg_win)
        assert bool(plan[3]) == (seg_win == 512)
        got = fn(*args, **kw, plan=plan)
        want = fn(*args, **kw, seg_win=seg_win)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), name


def _banded_case(seed, B=2, H=90, W=90, C=5, N=37, vh=7, vw=7):
    """tests/test_observe_parity.py:101's geometry: a random padded image,
    top-left cells of in-map agents (unpacked), a circular mask."""
    from magent_tpu_torch.ranges import circle_range

    rng = np.random.RandomState(seed)
    Hp, Wp, lanes, pad_y, pad_x = twg.padded_geometry(H, W, C, vh, vw)
    img = rng.uniform(size=(B, Hp, lanes)).astype(np.float32)
    xs = rng.randint(0, W, size=(B, N))
    ys = rng.randint(0, H, size=(B, N))
    pos = ((ys + pad_y) * Wp + xs + pad_x).astype(np.int32)
    mask = np.repeat(circle_range(vh // 2, 0.0, vw % 2).mask.astype(
        np.float32), C, axis=1)
    return img, pos, mask, dict(vh=vh, vw=vw, C=C, Wp=Wp)


@pytest.mark.parametrize("chunk,band_rows", [(8, 16), (40, 32)])
def test_window_gather_banded_matches_jax(chunk, band_rows):
    """``unsort=False``: the band-ordered windows (dummy rows included, the
    last band's reaching past the image) and ``inv`` equal the JAX
    kernel's; ``unsort=True``: the windows in slot order equal the plain
    window gather's."""
    img, pos, mask, kw = _banded_case(chunk + band_rows)
    band = dict(chunk=chunk, band_rows=band_rows)
    j_out, j_inv = jwg.window_gather_banded(
        jnp.asarray(img), jnp.asarray(pos), jnp.asarray(mask), **kw, **band,
        interpret=True, unsort=False)
    args = (_t(img), _t(pos), _t(mask))
    plain = twg.window_gather_ref(*args, **kw).numpy()
    for fn in (twg.window_gather_banded_ref, twg.window_gather_banded):
        out, inv = fn(*args, **kw, **band, unsort=False)
        assert out.dtype == torch.float32 and inv.dtype == torch.int32
        np.testing.assert_array_equal(inv.numpy(), np.asarray(j_inv))
        np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
        view = fn(*args, **kw, **band)
        np.testing.assert_array_equal(view.numpy(), plain)
    n_bands = -(-img.shape[1] // band_rows)
    assert out.shape[1] == -(-pos.shape[1] // chunk) * chunk + n_bands * chunk
    dummy = np.ones(out.shape[:2], bool)
    for b in range(pos.shape[0]):
        dummy[b, inv[b].numpy()] = False
    assert dummy.any() and out.numpy()[dummy].any()


def test_banded_tables_match_jax():
    """The band sort keeps slot order within a band; the chunk -> band
    table and the padded positions equal the JAX package's."""
    _, pos, _, kw = _banded_case(3, N=300)
    n_bands = -(-(pos.max() // kw["Wp"] + 8) // 16)
    got = twg.banded_tables(_t(pos), Wp=kw["Wp"], band_rows=16,
                            n_bands=n_bands, chunk=8)
    want = jwg.banded_tables(jnp.asarray(pos), Wp=kw["Wp"], band_rows=16,
                             n_bands=n_bands, chunk=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    inv = got[2].numpy()
    band = pos // (kw["Wp"] * 16)
    for b in range(pos.shape[0]):
        same = band[b][:, None] == band[b][None, :]
        lower = np.arange(pos.shape[1])[:, None] < np.arange(pos.shape[1])
        assert (inv[b][:, None] < inv[b][None, :])[same & lower].all()
