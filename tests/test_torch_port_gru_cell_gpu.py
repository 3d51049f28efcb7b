"""The GRU cell's kernels (``csrc/gru_cell.cu``) against their plain
versions (``ops/gru_cell.py`` ``gru_cell_ref``, ``gru_cell_backward_ref``)
on the card, forward and backward, in both forms, in f32 and bf16, with and
without the reset, at small shapes and at battle_drqn's [102,400, 512]:

- f32 results within rtol 1e-5, atol 1e-6;
- results in bf16 (the acting form's state, widened to f32; the carry in
  bf16; the backward's pre-activation gradients) within one bf16 ulp of
  the plain version's: a transcendental may land on the other side of a
  rounding;
- f32 gradients within rtol 1e-4 (atol 1e-6);
- the Function's gradients against autograd through the plain version in
  f32, within rtol 1e-4;
- one fused DRQN train step (``share_acting``, ``unroll_remat`` "all") at a
  tiny world launches the forward 3 and the backward once per acting step
  and group: the acting cell, its recompute, its backward and the target
  re-unroll's carry step;
- under ``tp`` (two gloo ranks on the card, each holding half of every GRU
  matmul's columns, so that the kernels get the all-gathered full-width
  projections) a DRQN train step gives the one-process step on the card:
  metrics within rtol 1e-5, every rank's gathered parameters and Adam
  moments by the Adam rule, the env state exactly.

Marked ``gpu``: each test decides at run time whether a card exists and
skips without one.  On a machine with an H100:
python -m pytest tests/test_torch_port_gru_cell_gpu.py -q"""

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as mr
from _torch_train_checks import assert_adam_steps_close
from magent_tpu_torch import ops
from magent_tpu_torch import random as trandom
from magent_tpu_torch.builtin.config import battle
from magent_tpu_torch.builtin.torch_model import DRQNNet
from magent_tpu_torch.core.state import FIELDS
from magent_tpu_torch.ops import _build
from magent_tpu_torch.ops import gru_cell as tgc
from magent_tpu_torch.parallel import (ClipAdam, VecGridWorld,
                                       init_drqn_hiddens, make_drqn_train_step)

pytestmark = pytest.mark.gpu

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (rows, state width): small and ragged, and the cell's
SHAPES = {"small": (7, 64), "ragged": (1001, 136), "cell": (102400, 512)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(shape, dtype, device, seed=0):
    N, H = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    h = 0.7 * torch.randn((N, H), generator=gen, device=device)
    proj = [(1.5 * torch.randn((N, H), generator=gen, device=device))
            .to(dtype) for _ in range(6)]
    bias = 0.2 * torch.randn((H,), generator=gen, device=device)
    keep = torch.rand((N, 1), generator=gen, device=device) > 0.25
    return h, proj, bias, keep


def _close(got, want, what):
    """f32 within rtol 1e-5 / atol 1e-6, bf16 within one ulp."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, msg=what)
        return
    a, b = got.float(), want.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    bad = (a - b).abs() > ulp
    assert not bool(bad.any()), "%s: %d of %d values over one bf16 ulp" % (
        what, int(bad.sum()), bad.numel())


def _grads_close(got, want, what):
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6, msg=what)
    else:
        _close(got, want, what)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_acting_form_matches_plain(cuda, shape, dtype):
    dt = DTYPES[dtype]
    h, proj, _, _ = _operands(SHAPES[shape], dt, cuda)
    before = ops.launch_counts()
    got = tgc.gru_cell(h, *proj)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gru_cell"] == before["gru_cell"] + 1
    want = tgc.gru_cell_ref(tgc.ACT, h, *proj)
    assert got.dtype == want.dtype == torch.float32
    # a value of the dtype, widened: compared in the dtype
    assert torch.equal(got, got.to(dt).float())
    _close(got.to(dt), want.to(dt), "state")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("reset", [False, True])
def test_carry_form_matches_plain(cuda, shape, dtype, reset):
    h, proj, bias, keep = _operands(SHAPES[shape], DTYPES[dtype], cuda, 1)
    keep = keep if reset else None
    got = tgc.gru_carry(h, *proj, bias, keep)
    want = tgc.gru_cell_ref(tgc.CARRY, h, *proj, bias, keep)
    for name, a, b in zip(("carry", "output", "carry in dtype"), got, want):
        _close(a, b, name)
    if reset:
        assert bool((got[0][~keep[:, 0]] == 0).all())


@pytest.mark.parametrize("form", ["act", "carry", "carry_reset"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_matches_plain(cuda, form, shape, dtype):
    dt = DTYPES[dtype]
    h, proj, bias, keep = _operands(SHAPES[shape], dt, cuda, 2)
    gen = torch.Generator(device=cuda).manual_seed(3)
    N, H = SHAPES[shape]

    def grad(t):
        return torch.randn((N, H), generator=gen, device=cuda).to(t)

    if form == "act":
        code, keep, bias = tgc.ACT, None, None
        g, extra = grad(torch.float32), (None, None)
    else:
        code = tgc.CARRY
        keep = keep if form == "carry_reset" else None
        g, extra = grad(torch.float32), (grad(torch.float32), grad(dt))
    before = ops.launch_counts()["gru_cell_backward"]
    got = tgc.gru_cell_backward(code, h, *proj, bias, keep, g, *extra, True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gru_cell_backward"] == before + 1
    want = tgc.gru_cell_backward_ref(code, h, *proj, bias, keep, g, *extra)
    names = ("r", "z", "in", "hn", "state", "hn f32")
    for name, a, b in zip(names, got, want):
        if a is None:  # the acting form writes hn's gradient once
            assert code == tgc.ACT and name == "hn f32"
            continue
        _grads_close(a, b, name)


@pytest.mark.parametrize("form", ["act", "carry", "carry_reset"])
def test_function_gradients_match_autograd_f32(cuda, form):
    """The Function's gradients of every operand against autograd through
    the plain op chain, f32, at the cell's shape."""
    h, proj, bias, keep = _operands(SHAPES["cell"], torch.float32, cuda, 4)
    keep = keep if form == "carry_reset" else None
    code = tgc.ACT if form == "act" else tgc.CARRY
    leaves = [t.clone().requires_grad_() for t in (h, *proj, bias)]
    w = [torch.linspace(-1, 1, h.numel(), device=cuda).reshape(h.shape) * s
         for s in (1.0, 0.5, -0.25)]
    got = []
    for fn in (tgc.GRUCellFunction.apply, None):
        for t in leaves:
            t.grad = None
        if fn is None:
            out = tgc.gru_cell_ref(code, leaves[0], *leaves[1:7], leaves[7],
                                   keep)
        else:
            out = fn(code, leaves[0], *leaves[1:7],
                     leaves[7] if code == tgc.CARRY else None, keep)
        outs = (out,) if code == tgc.ACT else out
        sum(((o.float() * wi).sum() for o, wi in zip(outs, w))).backward()
        got.append([t.grad for t in leaves])
    for i, (a, b) in enumerate(zip(*got)):
        if b is None:
            assert a is None or not bool(a.any())
            continue
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                   msg="operand %d" % i)


def test_drqn_train_step_launches(cuda):
    """One fused DRQN train step at battle map 20, [6, 6], B=4, rollout 3,
    bf16 nets: 3 forward launches (acting cell, its recompute, the target
    re-unroll's carry step) and one backward per acting step and group."""
    T = 3
    venv = VecGridWorld(battle.get_config(20), [6, 6], 4, device=cuda)
    G = venv.spec.n_groups
    tx = ClipAdam(1e-4, 5.0)
    nets = tuple(DRQNNet(venv.spec.view_space(g), venv.spec.feature_size(g),
                         venv.spec.groups[g].type.n_action,
                         dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(g)).to(cuda)
                 for g in range(G))
    targets = tuple(DRQNNet(venv.spec.view_space(g),
                            venv.spec.feature_size(g),
                            venv.spec.groups[g].type.n_action,
                            dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(9 + g)
                            ).to(cuda) for g in range(G))
    step = make_drqn_train_step(venv, tx, rollout_len=T, share_acting=True,
                                unroll_remat="all")
    state = venv.reset(trandom.PRNGKey(0).to(cuda))
    before = ops.launch_counts()
    out = step(nets, targets, tuple(tx.init(n) for n in nets), state,
               init_drqn_hiddens(venv, nets), trandom.PRNGKey(2).to(cuda),
               0.3)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    fwd = after["gru_cell"] - before["gru_cell"]
    bwd = after["gru_cell_backward"] - before["gru_cell_backward"]
    assert (fwd, bwd) == (3 * T * G, T * G)
    assert fwd + bwd == 4 * T * G
    assert bool(torch.isfinite(out[4]["loss"]).all())


def test_drqn_step_under_tp_on_the_card_matches_one_process(cuda, tmp_path):
    """Two gloo ranks on the card at tp=2 (``_torch_mesh_ranks``' drqn
    case: battle map 24, [8, 8], B=8, rollout 3, f32 nets) against the same
    step in this process on the card."""
    _build.lib()  # built here once, not by each rank
    mr.run_job(2, tmp_path, device="cuda", cases=("drqn_tp",))
    parts = [dict(np.load(tmp_path / ("drqn_tp_rank%d.npz" % r)))
             for r in range(2)]
    nets, opts, _, state, metrics = mr.train_case(
        "drqn", mr.venv_of(device=cuda))
    want = mr.net_arrays(nets, opts)
    for p in parts:
        assert list(p["dense_view_rows"]) == [128, 128]
        for k, v in metrics.items():
            np.testing.assert_allclose(p["metric/" + k], v.cpu().numpy(),
                                       rtol=1e-5, err_msg=k)
        for f in FIELDS:
            np.testing.assert_array_equal(p["state/" + f],
                                          getattr(state, f).cpu().numpy(),
                                          err_msg=f)
        for g in range(2):
            got, ref = ({kind: {k.split("/", 2)[2]: v for k, v in d.items()
                                if k.startswith("g%d/%s/" % (g, kind))}
                         for kind in ("param", "mu", "nu")}
                        for d in (p, want))
            assert_adam_steps_close(
                got["param"], ref["param"], (got["mu"], got["nu"]),
                (ref["mu"], ref["nu"]), lr=1e-4, moment_rtol=1e-5,
                param_atol=0.2e-4, tag="group %d" % g)
