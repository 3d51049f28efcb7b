"""The threefry kernel (``csrc/threefry.cu``) against the plain version on
the card, bit for bit: each public draw of ``magent_tpu_torch.random`` on a
CUDA key is one launch and equals the plain version run on the same CUDA
key and on its CPU copy, at the trainer's shapes (``split`` of one key and
of 64, e-greedy ``randint`` (64, 3200) over 21 actions, the learner's
``randint`` (16384,) over 1,433,600 rows), ``uniform`` (256, 3200) in its
three ranges, and ragged draws.  Marked ``gpu``: each test decides at run
time whether a card exists and skips without one.  On a machine with an
H100: python -m pytest tests/test_torch_port_threefry_gpu.py -q"""

import numpy as np
import pytest
import torch

from magent_tpu_torch import ops
from magent_tpu_torch import random as trandom
from magent_tpu_torch.ops import _build

pytestmark = pytest.mark.gpu

TINY = float(np.finfo(np.float32).tiny)
NEAR_M1 = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _keys(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**32, size=tuple(shape) + (2,),
                                         dtype=np.uint64).astype(np.int64))


def _key(seed):
    return trandom.PRNGKey(seed)


# name -> (draw, key on the CPU, the draw's other arguments)
CASES = {
    "split_key": (trandom.split, lambda: _key(2**32 - 1), ()),
    "split_64_keys": (trandom.split, lambda: _keys((64,), 1), ()),
    "split_sliced_keys": (trandom.split,
                          lambda: trandom.split(_keys((64,), 2))[:, 0], ()),
    "fold_in": (trandom.fold_in, lambda: _key(7), (1001,)),
    "fold_in_batched": (trandom.fold_in, lambda: _keys((3, 5), 3),
                        (2**32 - 1,)),
    "randint_egreedy": (trandom.randint, lambda: _key(11),
                        ((64, 3200), 0, 21)),
    "randint_learner": (trandom.randint, lambda: _key(12),
                        ((16384,), 0, 1433600)),
    "randint_batched": (trandom.randint, lambda: _keys((3, 5), 4),
                        ((7, 11), -40, 2**31 - 1)),
    "randint_empty_span": (trandom.randint, lambda: _key(13), ((9,), 3, -2)),
    "randint_negative": (trandom.randint, lambda: _key(14),
                         ((1000,), -2**31, -2**31 + 70000)),
    "uniform": (trandom.uniform, lambda: _key(21), ((256, 3200),)),
    "uniform_normal_range": (trandom.uniform, lambda: _key(22),
                             ((256, 3200), NEAR_M1, 1.0)),
    "uniform_gumbel_range": (trandom.uniform, lambda: _key(23),
                             ((256, 3200), TINY, 1.0)),
    "uniform_batched": (trandom.uniform, lambda: _keys((3, 5), 5), ((7, 11),)),
    "uniform_scalar_shape": (trandom.uniform, lambda: _keys((4,), 6), ((),)),
    "bits_batched": (trandom.bits, lambda: _keys((3, 5), 7), ((7, 11),)),
}


def _plain_on(key, draw, args, monkeypatch):
    """The plain version on ``key``'s device (the route said cpu)."""
    with monkeypatch.context() as m:
        m.setattr(_build, "route", lambda *t: "cpu")
        return draw(key, *args)


def _bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain(name, cuda, monkeypatch):
    """One launch per draw; the kernel's output equals the plain version
    on the card and on the CPU, bit for bit, dtype and shape too."""
    draw, make_key, args = CASES[name]
    key = make_key()
    want = draw(key, *args)
    plain_card = _plain_on(key.to(cuda), draw, args, monkeypatch)
    before = ops.launch_counts()["threefry"]
    got = draw(key.to(cuda), *args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["threefry"] == before + 1
    assert got.device.type == "cuda"
    for other in (want, plain_card):
        assert got.dtype == other.dtype and got.shape == other.shape
        assert torch.equal(_bits(got), _bits(other))


@pytest.mark.parametrize("draw, args", [
    (trandom.normal, ((33, 700),)), (trandom.gumbel, ((33, 700),)),
    (trandom.categorical, (torch.linspace(-2, 2, 64 * 21).reshape(64, 21),))],
    ids=["normal", "gumbel", "categorical"])
def test_float_tails_on_kernel_uniform(draw, args, cuda, monkeypatch):
    """normal, gumbel and categorical: one launch (their uniform), then
    their float tails as torch ops on the card, equal to the plain
    version's on the card bit for bit."""
    key = _key(31).to(cuda)
    args = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
    want = _plain_on(key, draw, args, monkeypatch)
    before = ops.launch_counts()["threefry"]
    got = draw(key, *args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["threefry"] == before + 1
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("draw, args", [
    (trandom.split, (_key(1), 0)), (trandom.uniform, (_key(2), (0, 5))),
    (trandom.randint, (_keys((3,), 3), (4, 0), 0, 3)),
    (trandom.bits, (_keys((0,), 4), (3,)))],
    ids=["split_0", "uniform_0x5", "randint_4x0", "bits_no_keys"])
def test_empty_draws(draw, args, cuda):
    """A draw of no values launches nothing and returns the plain
    version's empty tensor."""
    want = draw(*args)
    before = ops.launch_counts()["threefry"]
    got = draw(args[0].to(cuda), *args[1:])
    assert ops.launch_counts()["threefry"] == before
    assert got.device.type == "cuda" and got.dtype == want.dtype
    assert got.shape == want.shape
