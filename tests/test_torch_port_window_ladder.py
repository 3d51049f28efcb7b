"""The port's window-gather cost ladder (``magent_tpu_torch/ops/
window_ladder.py``) against ``scripts/profile_window.py``'s ``ladder`` and
``shared_tile``, run in interpret mode on the same numpy-seeded inputs.

The script fixes B, N and CHUNK at import and reads them while it traces,
so each geometry here has its own input shape (a jitted function retraces
only for a new shape).  It indexes its words at ``b * n_pad + n`` with
``n_pad = ceil(N / CHUNK) * CHUNK`` while it passes ``[B, N]`` words, so
it is right only where ``N % CHUNK == 0`` (or in env 0); the port indexes
each env's own words and is held against the script only there, and at
N=60, CHUNK=8 against ``window_gather_xla`` and against the script run on
each env alone.  The port's wrappers, on positions and on packed words,
take their plain versions on CPU tensors, so they are held too; the CUDA kernels are held against the plain
versions on the card (tests/test_torch_port_gpu.py, chip_smoke.py).

Tolerance: 0 everywhere (the levels are copies, one multiply by the mask,
or sums of small ints)."""

import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.ops import window_gather as jwg

from magent_tpu_torch.ops import window_ladder as wl
from magent_tpu_torch.tools import profile_window as tpw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, N, CHUNK) with N % CHUNK == 0: the script's interpret geometry, and
# one whose chunk is not a multiple of the kernel's 32-agent blocks
GEOMETRIES = [(4, 64, 8), (2, 72, 24)]
RAGGED = (4, 60, 8)


@pytest.fixture(scope="module")
def script():
    """``scripts/profile_window.py`` imported in interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGENT_PW_INTERPRET", "1")
        mp.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location(
            "profile_window_script",
            os.path.join(ROOT, "scripts", "profile_window.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    mod.shapes = {}
    return mod


def _run(script, geometry, fn, *args, **kwargs):
    """Call the script's ``fn`` at ``geometry``; a shape keeps its chunk
    (the script's traces are keyed by shape alone)."""
    B, N, chunk = geometry
    assert script.shapes.setdefault((B, N), chunk) == chunk
    script.B, script.N, script.CHUNK = B, N, chunk
    return np.asarray(fn(*(jnp.asarray(a) for a in args), **kwargs))


def _inputs(script, B, N, seed):
    """An image, top-left cells of agents anywhere on the map, a random 0/1
    mask (numpy)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, script.W, (B, N))
    y = rng.randint(0, script.H, (B, N))
    pos = ((y + script.PAD_Y - script.VH // 2) * script.Wp + x
           + script.PAD_X - script.VW // 2).astype(np.int32)
    gfull = rng.uniform(size=(B, script.Hp, script.LANES_IMG)).astype(
        np.float32)
    mask = (rng.uniform(size=(script.VH, script.VWC)) < 0.7).astype(
        np.float32)
    return gfull, pos, mask


def _kw(script, chunk):
    return dict(chunk=chunk, vh=script.VH, vw=script.VW, C=script.C,
                Wp=script.Wp)


def _port(fn, args, **kw):
    return fn(*(torch.from_numpy(a) for a in args), **kw).numpy()


def _packed(fn):
    """``fn`` (``ladder_packed`` or ``shared_tile_packed``) on the words
    of ``precompute``, called as the entry point on positions."""
    def call(gfull, pos, mask, *, Wp, **kw):
        return fn(gfull, *wl.precompute(pos, Wp=Wp, C=kw["C"]), mask, **kw)
    return call


LADDERS = (wl.ladder_ref, wl.ladder, _packed(wl.ladder_packed))
SHARED_TILES = (wl.shared_tile_ref, wl.shared_tile,
                _packed(wl.shared_tile_packed))


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_precompute_matches_script(script, geometry):
    B, N, _ = geometry
    _, pos, _ = _inputs(script, B, N, seed=N)
    want = script.precompute(jnp.asarray(pos))
    got = wl.precompute(torch.from_numpy(pos), Wp=script.Wp, C=script.C)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("level", wl.LEVELS)
def test_ladder_matches_script(script, level, geometry):
    B, N, chunk = geometry
    args = _inputs(script, B, N, seed=N)
    want = _run(script, geometry, script.ladder, *args, level=level)
    assert want.shape == (B, N, script.VH, script.VWC)
    for fn in LADDERS:
        got = _port(fn, args, level=level, **_kw(script, chunk))
        np.testing.assert_array_equal(got, want)
    if level not in ("floor", "smem"):
        assert (want != 0).mean() > 0.5


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_shared_tile_matches_script(script, geometry):
    B, N, chunk = geometry
    args = _inputs(script, B, N, seed=N)
    want = _run(script, geometry, script.shared_tile, *args)
    for fn in SHARED_TILES:
        got = _port(fn, args, **_kw(script, chunk))
        np.testing.assert_array_equal(got, want)
    # the chunk's shared corner differs from the agents' own windows
    own = _port(wl.ladder_ref, args, level="mask", **_kw(script, chunk))
    assert not np.array_equal(want, own)


@pytest.mark.parametrize("level", ["roll2", "mask"])
def test_ragged_windows_match_xla_in_every_env(script, level):
    """N % CHUNK != 0: ``roll2`` is the true window and ``mask`` the
    masked one, in every env (the script's envs after the first read other
    agents' words here)."""
    B, N, chunk = RAGGED
    gfull, pos, mask = _inputs(script, B, N, seed=7)
    if level == "roll2":
        mask = np.ones_like(mask)
    want = np.asarray(jwg.window_gather_xla(
        jnp.asarray(gfull), jnp.asarray(pos), jnp.asarray(mask),
        vh=script.VH, vw=script.VW, C=script.C, Wp=script.Wp))
    for fn in LADDERS:
        got = _port(fn, (gfull, pos, mask), level=level,
                    **_kw(script, chunk))
        for b in range(B):
            np.testing.assert_array_equal(got[b], want[b])


def test_ragged_shared_tile_matches_each_env_alone(script):
    """N % CHUNK != 0: the port's batched ``shared_tile`` equals the
    script's run on each env alone (B=1, where its word index is right)."""
    B, N, chunk = RAGGED
    gfull, pos, mask = _inputs(script, B, N, seed=8)
    for fn in SHARED_TILES:
        got = _port(fn, (gfull, pos, mask), **_kw(script, chunk))
        for b in range(B):
            want = _run(script, (1, N, chunk), script.shared_tile,
                        gfull[b:b + 1], pos[b:b + 1], mask)
            np.testing.assert_array_equal(got[b:b + 1], want)


def test_wrappers_refuse_bad_operands(script):
    gfull, pos, mask = (torch.from_numpy(a)
                        for a in _inputs(script, 1, 8, seed=0))
    kw = _kw(script, 8)
    with pytest.raises(ValueError, match="level"):
        wl.ladder(gfull, pos, mask, level="epi", **kw)
    for fn in (lambda **k: wl.ladder(gfull, pos, mask, level="mask", **k),
               lambda **k: wl.shared_tile(gfull, pos, mask, **k)):
        with pytest.raises(ValueError, match="tile"):
            fn(**dict(kw, vh=wl.MAX_VH + 1))
        with pytest.raises(ValueError, match="tile"):
            fn(**dict(kw, vw=14))  # 14 * 5 lanes > 65
        with pytest.raises(ValueError, match="chunk"):
            fn(**dict(kw, chunk=0))
    tall = torch.zeros((1, 1, 1)).expand(1, wl.MAX_HP + 8, gfull.shape[2])
    with pytest.raises(ValueError, match="packed word"):
        wl.ladder(tall, pos, mask, level="load", **kw)


def test_cli_cpu_run_passes_its_check(capsys):
    assert tpw.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    for name in tpw.VARIANTS:
        assert "\n%-8s " % name in "\n" + out
    assert "window_gather4 vs window_gather_ref max|diff| = 0\n" in out
    assert "ladder(mask) vs window_gather4 max|diff| = 0\n" in out
    with pytest.raises(SystemExit):
        tpw.main(["--cpu", "epi"])


def test_profile_tool_imports_no_jax():
    """The ladder's tool pulls in neither JAX nor the JAX package."""
    code = ("import sys, magent_tpu_torch.tools.profile_window; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'magent_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
