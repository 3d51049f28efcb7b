"""The port's threefry draws on the CPU: the plain version's values pinned
to literal words, with no kernel launch and nothing built; the card
kernel's source registered and not built at import; and the draws' card
route (``random.py`` -> ``ops/threefry.py`` -> the C launcher's arguments)
replayed through a NumPy twin of ``csrc/threefry.cu`` that reads its
operands from the launcher's pointers, against the plain version at the
trainer's and ragged shapes.  The kernel itself runs only on a card:
tests/test_torch_port_threefry_gpu.py."""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from magent_tpu_torch import ops
from magent_tpu_torch import random as trandom
from magent_tpu_torch.ops import _build
from magent_tpu_torch.ops import threefry as tthreefry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # many small tensor ops: one intra-op thread keeps the test workers
    # from stalling each other's OpenMP barriers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEY = trandom.PRNGKey(42)
TINY = float(np.finfo(np.float32).tiny)
NEAR_M1 = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

# jax.random's words for PRNGKey(42) (partitionable threefry), as the plain
# version computes them; floats by their hex
PINNED = {
    "split": (lambda: trandom.split(KEY),
              [[1832780943, 270669613], [64467757, 2916123636]]),
    "split3": (lambda: trandom.split(KEY, 3),
               [[1832780943, 270669613], [64467757, 2916123636],
                [2465931498, 255383827]]),
    "fold_in": (lambda: trandom.fold_in(KEY, 7), [2547012911, 1371500959]),
    "bits": (lambda: trandom.bits(KEY, (2, 3)),
             [[2098992034, 2919706841, 2646866425],
              [2409546199, 1935504149, 2516274904]]),
    "uniform": (lambda: trandom.uniform(KEY, (5,)),
                ["0x1.f470480000000p-2", "0x1.5c0e600000000p-1",
                 "0x1.3b87f00000000p-1", "0x1.1f3d800000000p-1",
                 "0x1.cd75c80000000p-2"]),
    "uniform_scaled": (lambda: trandom.uniform(KEY, (4,), -2.5, 3.0),
                       ["0x1.80d3180000000p-3", "0x1.3d27880000000p+0",
                        "0x1.c76ba80000000p-1", "0x1.2bd2400000000p-1"]),
    "randint": (lambda: trandom.randint(KEY, (6,), 0, 21),
                [15, 12, 18, 4, 5, 3]),
    "randint_wide": (lambda: trandom.randint(KEY, (4,), -7, 1433593),
                     [46269, 569355, 492720, 1178810]),
    "randint_empty_span": (lambda: trandom.randint(KEY, (3,), 5, 5),
                           [5, 5, 5]),
}
DTYPES = {"uniform": torch.float32, "uniform_scaled": torch.float32,
          "randint": torch.int32, "randint_wide": torch.int32,
          "randint_empty_span": torch.int32}


def _refuse_launch(*args, **kwargs):
    raise AssertionError("a CPU draw reached the kernel launcher")


@pytest.mark.parametrize("name", sorted(PINNED))
def test_cpu_draws_pinned_without_launch(name, monkeypatch):
    """A CPU key takes the plain version: today's values, word for word,
    and no launch (the launcher refuses; the counter stays)."""
    monkeypatch.setattr(_build, "launch", _refuse_launch)
    before = ops.launch_counts()["threefry"]
    draw, want = PINNED[name]
    got = draw()
    assert got.device.type == "cpu"
    assert got.dtype == DTYPES.get(name, torch.int64)
    if got.dtype == torch.float32:
        assert [float(x).hex() for x in got] == want
    else:
        assert got.tolist() == want
    assert ops.launch_counts()["threefry"] == before


def test_source_registered_not_built_at_import():
    """threefry.cu is one of the library's sources with its launcher's
    signature and counter; importing the package and drawing on the CPU
    builds and loads nothing."""
    assert "threefry.cu" in _build.SOURCES
    assert (_build.CSRC / "threefry.cu").is_file()
    assert "magent_threefry" in _build._SIGNATURES
    assert "threefry" in ops.KERNELS
    code = (
        "import magent_tpu_torch, torch\n"
        "from magent_tpu_torch import random as r\n"
        "from magent_tpu_torch.ops import _build\n"
        "assert _build._lib is None and not _build.LAUNCHES\n"
        "def refuse(*a, **k): raise AssertionError('build at import')\n"
        "_build.build = refuse\n"
        "k = r.PRNGKey(3)\n"
        "r.randint(r.fold_in(r.split(k)[1], 2), (4,), 0, 9)\n"
        "r.normal(k, (3,)); r.categorical(k, torch.zeros(2, 5))\n"
        "assert _build._lib is None and not _build.LAUNCHES\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# the card route, with the launcher replaced by a NumPy twin of the kernel

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _np_threefry(k0, k1, x0, x1):
    """csrc/threefry.cu ``threefry`` on uint32 arrays (wrapping)."""
    k2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0, x1 = x0 + k0, x1 + k1
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _memory(ptr, ctype, n):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


def _twin_launch(calls):
    """A stand-in for ``_build.launch``: checks the launch geometry, then
    computes what ``magent_threefry`` writes, reading the key rows from
    their pointer at their row stride."""
    def launch(name, device, key, stride, count, total, mode, base, span,
               mult, minval, lo, scale, scaled, blocks, out):
        assert name == "magent_threefry"
        assert total > 0 and count > 0 and total % count == 0
        assert blocks == min(-(-total // tthreefry.THREADS),
                             132 * tthreefry.BLOCKS_PER_SM)
        calls.append(mode)
        rows = total // count
        words = _memory(key, ctypes.c_int64, (rows - 1) * stride + 2)
        row = np.arange(total, dtype=np.int64) // count
        n = np.arange(total, dtype=np.int64) - row * count
        k0 = words[row * stride].astype(np.uint32)
        k1 = words[row * stride + 1].astype(np.uint32)
        zero = np.zeros(total, np.uint32)
        if mode == tthreefry.WORDS:
            x0, x1 = _np_threefry(k0, k1, zero, np.uint32(base)
                                  + n.astype(np.uint32))
            _memory(out, ctypes.c_int64, 2 * total)[:] = np.stack(
                [x0, x1], -1).astype(np.int64).reshape(-1)
            return
        hi_n, lo_n = (n >> 32).astype(np.uint32), n.astype(np.uint32)
        if mode == tthreefry.RANDINT:
            h0, h1 = _np_threefry(k0, k1, zero, zero)
            l0, l1 = _np_threefry(k0, k1, zero, zero + np.uint32(1))
            hi = np.bitwise_xor(*_np_threefry(h0, h1, hi_n, lo_n))
            lo_w = np.bitwise_xor(*_np_threefry(l0, l1, hi_n, lo_n))
            span_, mult_ = np.uint32(span), np.uint32(mult)
            off = (hi % span_) * mult_
            off = (off + lo_w % span_) % span_
            _memory(out, ctypes.c_int32, total)[:] = (
                off + np.uint32(minval & 0xFFFFFFFF)).view(np.int32)
            return
        b = np.bitwise_xor(*_np_threefry(k0, k1, hi_n, lo_n))
        if mode == tthreefry.BITS:
            _memory(out, ctypes.c_int64, total)[:] = b.astype(np.int64)
            return
        assert mode == tthreefry.UNIFORM
        f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) \
            - np.float32(1.0)
        if scaled:
            lo32 = np.float32(lo)
            v = (f.astype(np.float64) * np.float64(np.float32(scale))
                 + np.float64(lo32)).astype(np.float32)
            f = np.where(v < lo32, lo32, v)
        _memory(out, ctypes.c_float, total)[:] = f
    return launch


def _card_route(monkeypatch):
    """Send the draws' CPU keys down the card route: ``route`` says cuda,
    the launcher is the twin; -> the list of launched modes."""
    calls = []
    monkeypatch.setattr(_build, "route", lambda *t: "cuda")
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "launch", _twin_launch(calls))
    return calls


def _keys(shape, seed=5):
    """Independent keys of ``shape`` + (2,), uint32 words in int64."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**32, size=tuple(shape) + (2,),
                                         dtype=np.uint64).astype(np.int64))


KEY1 = trandom.PRNGKey(2**32 - 3)
KEYS64 = _keys((64,))
# rows 4 words apart: split's first halves, as the engine keeps them
SLICED = trandom.split(_keys((64,), seed=6))[:, 0]
KEYS35 = _keys((3, 5), seed=7)
# name -> (draw, arguments): the trainer's draws (e-greedy at a cut battle
# batch, the learner's minibatch past 2**16), the env's uniform in its
# three ranges, then ragged ones
CASES = {
    "split_key": (trandom.split, (KEY1,)),
    "split_64_keys": (trandom.split, (KEYS64,)),
    "split_sliced_keys": (trandom.split, (SLICED,)),
    "split_5": (trandom.split, (KEYS35, 5)),
    "fold_in": (trandom.fold_in, (KEY1, 1001)),
    "fold_in_wraps": (trandom.fold_in, (KEYS35, 2**32 + 7)),
    "randint_egreedy": (trandom.randint, (KEY1, (64, 320), 0, 21)),
    "randint_learner": (trandom.randint, (KEY1, (16384,), 0, 1433600)),
    "randint_negative": (trandom.randint, (KEYS35, (7, 11), -40,
                                           2**31 - 1)),
    "randint_sliced": (trandom.randint, (SLICED, (3,), -2**31, 2**31 - 1)),
    "randint_empty_span": (trandom.randint, (KEY1, (9,), 3, -2)),
    "uniform": (trandom.uniform, (KEY1, (256, 64))),
    "uniform_normal_range": (trandom.uniform, (KEY1, (256, 64), NEAR_M1,
                                               1.0)),
    "uniform_gumbel_range": (trandom.uniform, (KEY1, (256, 64), TINY, 1.0)),
    "uniform_batched": (trandom.uniform, (KEYS35, (7, 11))),
    "uniform_sliced": (trandom.uniform, (SLICED, (5,), -3.0, 2.0)),
    "bits_batched": (trandom.bits, (KEYS35, (7, 11))),
    "bits_scalar_shape": (trandom.bits, (KEYS64, ())),
    "normal": (trandom.normal, (KEY1, (33, 7))),
    "gumbel": (trandom.gumbel, (KEY1, (33, 7))),
    "categorical": (trandom.categorical, (
        KEY1, torch.linspace(-1, 1, 5 * 21).reshape(5, 21))),
}
# the launch each draw makes: normal, gumbel and categorical through their
# uniform
MODES = {"split": tthreefry.WORDS, "fold": tthreefry.WORDS,
         "randint": tthreefry.RANDINT, "uniform": tthreefry.UNIFORM,
         "bits": tthreefry.BITS, "normal": tthreefry.UNIFORM,
         "gumbel": tthreefry.UNIFORM, "categorical": tthreefry.UNIFORM}


def _same(got, want):
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_card_route_equals_plain(name, monkeypatch):
    """Each draw on the card route is one launch (``uniform`` draws no
    ``bits``, ``randint`` no ``split``) whose arguments make the twin
    write the plain version's values, bit for bit, in its dtype and
    shape."""
    draw, args = CASES[name]
    want = draw(*args)  # the plain version
    calls = _card_route(monkeypatch)
    got = draw(*args)
    assert calls == [MODES[name.split("_")[0]]]
    assert _same(got, want)


@pytest.mark.parametrize("draw, args", [
    (trandom.split, (KEY1, 0)),
    (trandom.uniform, (KEY1, (0, 5))),
    (trandom.randint, (KEYS35, (4, 0), 0, 3)),
    (trandom.bits, (KEYS64[:0], (3,))),
], ids=["split_0", "uniform_0x5", "randint_4x0", "bits_no_keys"])
def test_card_route_empty_draws_launch_nothing(draw, args, monkeypatch):
    """A draw of no values allocates its empty output and launches
    nothing, as the plain version returns its empty tensor."""
    want = draw(*args)
    calls = _card_route(monkeypatch)
    got = draw(*args)
    assert calls == [] and _same(got, want) and got.numel() == 0
