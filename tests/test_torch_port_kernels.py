"""Plain versions of the port's kernels against the JAX package: the
Pallas kernels in interpret mode and their ``*_xla`` references, on the
same numpy-seeded inputs.  On CPU tensors each port wrapper calls its plain
version, so the wrappers are held here too; the CUDA kernels themselves are
held against the plain versions on the card (tests/test_torch_port_gpu.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.ops import attack_prefix as jap
from magent_tpu.ops import window_gather as jwg

from magent_tpu_torch.builtin.config import battle as tbattle
from magent_tpu_torch.ops import _build
from magent_tpu_torch.ops import attack_prefix as tap
from magent_tpu_torch.ops import window_gather as twg
from magent_tpu_torch import spec as tspec

B = 2
# f32 pair sums: the Pallas kernel, the xla einsum and the port add the
# same terms in different orders (the JAX package's own kernel test uses
# the same bound, tests/test_pairwise_kernels.py:41)
PAIR_ATOL = 1e-5


@pytest.fixture(params=[97, 512, 777])
def arrays(request):
    """Batched [B, A] operands from a numpy seed, with the engine's
    sentinel conventions."""
    A = request.param
    rng = np.random.RandomState(A)
    tgt = rng.randint(-1, A, size=(B, A)).astype(np.int32)
    tgt = np.where(tgt < 0, A, tgt).astype(np.int32)  # engine's no-target
    bits = rng.randint(0, 2**32, size=(B, A), dtype=np.uint64).astype(np.uint32)
    dmg = rng.uniform(size=(B, A)).astype(np.float32)
    hp = (rng.uniform(size=(B, A)) * 10).astype(np.float32)
    # unique occupied cells (1x1 bodies), some dead
    cell = np.stack([rng.permutation(3 * A)[:A] for _ in range(B)]).astype(np.int32)
    cell = np.where(rng.uniform(size=(B, A)) < 0.1, tap.CELL_DEAD, cell).astype(np.int32)
    acell = rng.randint(0, 3 * A, size=(B, A)).astype(np.int32)
    acell = np.where(rng.uniform(size=(B, A)) < 0.2, tap.QUERY_NONE, acell).astype(np.int32)
    # contested move targets and non-movers
    tcell = rng.randint(0, A, size=(B, A)).astype(np.int32)
    tcell = np.where(rng.uniform(size=(B, A)) < 0.2, tap.QUERY_NONE, tcell).astype(np.int32)
    return dict(tgt=tgt, bits=bits, dmg=dmg, hp=hp, cell=cell, acell=acell,
                tcell=tcell)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_pack_rank_matches_jax(arrays):
    A = arrays["tgt"].shape[1]
    got = tap.pack_rank(_t(arrays["bits"].astype(np.int64)), A).numpy()
    for b in range(B):
        want = np.asarray(jap.pack_rank(jnp.asarray(arrays["bits"][b]), A))
        np.testing.assert_array_equal(got[b], want)
    assert got.dtype == np.int32


def test_occupant_matches_jax(arrays):
    acell, cell, hp = arrays["acell"], arrays["cell"], arrays["hp"]
    ref = tap.occupant_ref(_t(acell), _t(cell), _t(hp))
    wrapped = tap.occupant(_t(acell), _t(cell), _t(hp))
    for b in range(B):
        for fn in (lambda *a: jap.occupant_tpu(*a, interpret=True),
                   jap.occupant_xla):
            t_want, h_want = fn(jnp.asarray(acell[b]), jnp.asarray(cell[b]),
                                jnp.asarray(hp[b]))
            for tgt, hpt in (ref, wrapped):
                np.testing.assert_array_equal(tgt[b].numpy(), np.asarray(t_want))
                np.testing.assert_allclose(hpt[b].numpy(), np.asarray(h_want),
                                           atol=PAIR_ATOL, rtol=0)
    assert (ref[0].numpy() >= 0).sum() > 0  # the case has hits


def test_rank_prefix_matches_jax(arrays):
    A = arrays["tgt"].shape[1]
    tgt, dmg = arrays["tgt"], arrays["dmg"]
    rank = tap.pack_rank(_t(arrays["bits"].astype(np.int64)), A)
    ref = tap.rank_prefix_ref(_t(tgt), rank, _t(dmg))
    wrapped = tap.rank_prefix(_t(tgt), rank, _t(dmg))
    for b in range(B):
        args = (jnp.asarray(tgt[b]), jnp.asarray(rank[b].numpy()),
                jnp.asarray(dmg[b]))
        for want in (jap.rank_prefix_tpu(*args, interpret=True),
                     jap.rank_prefix_xla(*args)):
            for got in (ref, wrapped):
                np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                           atol=PAIR_ATOL, rtol=0)
    assert (ref.numpy() > 0).sum() > 0


def test_rank_prefix_battle_damage_is_exact(arrays):
    """Battle's damage is 2.0: every partial sum is exact in any order, so
    the plain version equals the Pallas kernel bit for bit."""
    A = arrays["tgt"].shape[1]
    tgt = arrays["tgt"] % 7  # many shared targets
    dmg = np.full((B, A), 2.0, np.float32)
    rank = tap.pack_rank(_t(arrays["bits"].astype(np.int64)), A)
    got = tap.rank_prefix(_t(tgt), rank, _t(dmg)).numpy()
    for b in range(B):
        want = jap.rank_prefix_tpu(jnp.asarray(tgt[b]),
                                   jnp.asarray(rank[b].numpy()),
                                   jnp.asarray(dmg[b]), interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(want))


def test_rank_prefix_hp_form_matches_jax(arrays):
    """The grid path's form: P as above plus the target's hp.  A third of
    the rows carry the no-target sentinel A (zero damage, as the engine
    gives them) and read hp_t = 0; hp_t is a one-hot sum, so exact."""
    A = arrays["tgt"].shape[1]
    rng = np.random.RandomState(A + 1)
    tgt = np.where(rng.uniform(size=(B, A)) < 0.3, A, arrays["tgt"]).astype(np.int32)
    dmg = np.where(tgt == A, 0.0, arrays["dmg"]).astype(np.float32)
    hp = arrays["hp"]
    rank = tap.pack_rank(_t(arrays["bits"].astype(np.int64)), A)
    ref = tap.rank_prefix_ref(_t(tgt), rank, _t(dmg), _t(hp))
    wrapped = tap.rank_prefix(_t(tgt), rank, _t(dmg), _t(hp))
    for b in range(B):
        args = (jnp.asarray(tgt[b]), jnp.asarray(rank[b].numpy()),
                jnp.asarray(dmg[b]), jnp.asarray(hp[b]))
        for want_p, want_hp in (jap.rank_prefix_tpu(*args, interpret=True),
                                jap.rank_prefix_xla(*args)):
            for got_p, got_hp in (ref, wrapped):
                assert got_hp.dtype == torch.float32
                np.testing.assert_allclose(got_p[b].numpy(), np.asarray(want_p),
                                           atol=PAIR_ATOL, rtol=0)
                np.testing.assert_array_equal(got_hp[b].numpy(),
                                              np.asarray(want_hp))
    hp_t = ref[1].numpy()
    assert (tgt == A).sum() > 0 and (hp_t[tgt == A] == 0).all()
    np.testing.assert_array_equal(
        hp_t[tgt < A], np.take_along_axis(hp, np.minimum(tgt, A - 1), 1)[tgt < A])


def test_move_claims_matches_jax(arrays):
    """Both results are ints: exact, on every row — the non-movers share
    one sentinel cell (the grid path's H*W) and count one another."""
    A = arrays["tgt"].shape[1]
    sentinel = 3 * A  # above every target cell, as H*W is on the grid path
    tcell = np.where(arrays["tcell"] == tap.QUERY_NONE, sentinel,
                     arrays["tcell"]).astype(np.int32)
    ref = tap.move_claims_ref(_t(tcell))
    wrapped = tap.move_claims(_t(tcell))
    for b in range(B):
        for want in (jap.move_claims_tpu(jnp.asarray(tcell[b]), interpret=True),
                     jap.move_claims_xla(jnp.asarray(tcell[b]))):
            for got in (ref, wrapped):
                for g, w in zip(got, want):
                    assert g.dtype == torch.int32
                    np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    cnt, head = ref
    sent = tcell == sentinel
    assert sent.sum() > 1 and (cnt.numpy()[sent] > 0).any()
    assert (head.numpy() <= np.arange(A)).all()


def test_move_resolve_matches_jax(arrays):
    """All three results are ints: exact.  Every query matches itself, so
    the head is always a real slot (no sentinel to reconcile)."""
    tcell, cell = arrays["tcell"], arrays["cell"]
    ref = tap.move_resolve_ref(_t(tcell), _t(cell))
    wrapped = tap.move_resolve(_t(tcell), _t(cell))
    for b in range(B):
        args = (jnp.asarray(tcell[b]), jnp.asarray(cell[b]))
        for want in (jap.move_resolve_tpu(*args, interpret=True),
                     jap.move_resolve_xla(*args)):
            for got in (ref, wrapped):
                for g, w in zip(got, want):
                    assert g.dtype == torch.int32
                    np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    cnt, head, occ = ref
    assert (cnt.numpy() > 0).sum() > 0 and (occ.numpy() >= 0).sum() > 0


@pytest.mark.parametrize("map_size", [20, 33])
def test_padded_geometry_matches_jax(map_size):
    spec = tspec.compile_spec(tbattle.get_config(map_size), [5, 5])
    C = spec.n_channel
    vr = spec.groups[0].type.view_range
    assert twg.padded_geometry(map_size, map_size, C, vr.height, vr.width) == \
        jwg.padded_geometry(map_size, map_size, C, vr.height, vr.width)


def test_window_gather_matches_jax():
    """Battle's 13x13x7 window over a map-20 padded image: the plain version
    and the wrapper equal the Pallas roll kernel (interpret mode) and its
    xla reference exactly — a masked copy."""
    spec = tspec.compile_spec(tbattle.get_config(20), [15, 15])
    C = spec.n_channel
    vr = spec.groups[0].type.view_range
    vh, vw = vr.height, vr.width
    Hp, Wp, lanes, pad_y, pad_x = twg.padded_geometry(20, 20, C, vh, vw)
    rng = np.random.RandomState(3)
    N = 30
    img = rng.uniform(size=(B, Hp, lanes)).astype(np.float32)
    # window top-lefts of in-map agents (x, y in [0, 20))
    xs = rng.randint(0, 20, size=(B, N)) + vr.x1 + pad_x
    ys = rng.randint(0, 20, size=(B, N)) + vr.y1 + pad_y
    pos = (ys * Wp + xs).astype(np.int32)
    mask = np.repeat(vr.mask.astype(np.float32), C, axis=1)
    kw = dict(vh=vh, vw=vw, C=C, Wp=Wp)
    got_ref = twg.window_gather_ref(_t(img), _t(pos), _t(mask), **kw).numpy()
    got = twg.window_gather(_t(img), _t(pos), _t(mask), **kw).numpy()
    want_pl = np.asarray(jwg.window_gather(
        jnp.asarray(img), jnp.asarray(pos) * 1024, jnp.asarray(mask),
        chunk=32, interpret=True, **kw))
    want_xla = np.asarray(jwg.window_gather_xla(
        jnp.asarray(img), jnp.asarray(pos), jnp.asarray(mask), **kw))
    assert got.shape == (B, N, vh, vw * C)
    for g in (got_ref, got):
        np.testing.assert_array_equal(g, want_pl)
        np.testing.assert_array_equal(g, want_xla)


def test_wrappers_route_by_device():
    """CPU tensors take the plain version; any other device (here 'meta')
    or a mix of devices raises instead of falling back."""
    cpu = torch.zeros((1, 4), dtype=torch.int32)
    meta = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    assert _build.route(cpu, cpu) == "cpu"
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        tap.move_resolve(meta, meta)
    with pytest.raises(ValueError):
        _build.route(cpu, meta)


def test_operand_checks():
    """The kernel path validates dtype, shape and contiguity before any
    pointer reaches the C launcher."""
    t = torch.zeros((2, 8), dtype=torch.int32)
    _build.check(t, "t", torch.int32, (2, 8), t.device)
    with pytest.raises(ValueError, match="dtype"):
        _build.check(t.float(), "t", torch.int32, (2, 8), t.device)
    with pytest.raises(ValueError, match="shape"):
        _build.check(t, "t", torch.int32, (2, 9), t.device)
    with pytest.raises(ValueError, match="contiguous"):
        _build.check(t.T.contiguous().T, "t", torch.int32, (2, 8), t.device)
