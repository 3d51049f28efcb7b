"""The GRU cell's gates (``magent_tpu_torch/ops/gru_cell.py``) on the CPU,
at N=7 rows and a state of H=64:

- ``GRUCellFunction`` built on the plain versions (``gru_cell_ref`` forward,
  the hand-derived ``gru_cell_backward_ref`` backward: what the Function
  runs on CPU tensors) passes ``torch.autograd.gradcheck`` in f64 (its
  fast mode: random projections of the Jacobians), in the
  acting form and in the carry form with and without the reset, through
  each of the carry form's outputs alone and all three together;
- ``GRUCell``, ``DRQNNet`` and ``split_unroll`` on the CPU give, bit for
  bit, what the cell's op chain gave before the kernel (copied below), in
  f32 and bf16, forward and (f32) backward: the CPU path is unchanged."""

import pytest
import torch

from magent_tpu_torch.builtin.torch_model import DRQNNet, split_unroll
from magent_tpu_torch.ops import gru_cell as tgc
from magent_tpu_torch.parallel.sharding import linear, matmul

N, H = 7, 64
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _operands(seed, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    h = 0.5 * torch.randn((N, H), generator=gen, dtype=torch.float64)
    proj = [torch.randn((N, H), generator=gen, dtype=torch.float64).to(dtype)
            for _ in range(6)]
    bias = 0.1 * torch.randn((H,), generator=gen, dtype=torch.float64)
    keep = torch.rand((N, 1), generator=gen) > 0.4
    return h, proj, bias, keep


# (form, keep, which outputs the sum reads): the carry form through the
# carry, the output and the carry in the projections' dtype, alone and
# together
GRADCHECK_CASES = {
    "act": (tgc.ACT, False, (0,)),
    "carry": (tgc.CARRY, False, (0, 1, 2)),
    "carry_reset": (tgc.CARRY, True, (0, 1, 2)),
    "carry_reset_carry_only": (tgc.CARRY, True, (0,)),
    "carry_reset_output_only": (tgc.CARRY, True, (1,)),
    "carry_reset_carry_dt_only": (tgc.CARRY, True, (2,)),
}


@pytest.mark.parametrize("case", sorted(GRADCHECK_CASES))
def test_function_on_the_plain_versions_passes_gradcheck(case):
    form, reset, reads = GRADCHECK_CASES[case]
    h, proj, bias, keep = _operands(1)
    keep = keep if reset else None
    inputs = [t.requires_grad_() for t in (h, *proj, bias)]

    def cell(h, xr, xz, xn, ar, az, an, bias):
        out = tgc.GRUCellFunction.apply(
            form, h, xr, xz, xn, ar, az, an,
            bias if form == tgc.CARRY else None, keep)
        outs = (out,) if form == tgc.ACT else out
        return tuple(outs[i] for i in reads)

    assert torch.autograd.gradcheck(cell, inputs, eps=1e-6, atol=1e-7,
                                    fast_mode=True)


def test_backward_ref_names_each_gradient():
    """The hand-derived backward's six results in the acting form of a
    bf16 cell: four pre-activation gradients in bf16, the state's and
    hn's in f32, each equal to autograd through the f64 chain within
    bf16's rounding."""
    h, proj, _, _ = _operands(2, torch.bfloat16)
    h = h.float()
    g = torch.randn((N, H), generator=torch.Generator().manual_seed(3))
    got = tgc.gru_cell_backward_ref(tgc.ACT, h, *proj, None, None, g)
    assert [t.dtype for t in got] == [torch.bfloat16] * 4 + [torch.float32] * 2
    wide = [t.double().requires_grad_() for t in (h, *proj)]
    out = tgc.gru_cell_ref(tgc.ACT, *wide)
    grads = torch.autograd.grad(out, wide, g.double())
    want = (grads[1], grads[2], grads[3], grads[6], grads[0], grads[6])
    assert torch.equal(grads[1], grads[4]) and torch.equal(grads[2], grads[5])
    for a, b in zip(got, want):
        torch.testing.assert_close(a.double(), b, rtol=0.05, atol=0.05)


# ---------------------------------------------- the op chain before the kernel
def _chain_cell(cell, h, x):
    dt = cell.dtype
    h, x = h.to(dt), x.to(dt)
    lin = lambda k, v: linear(cell.get_submodule(k), v, dt)  # noqa: E731
    r = torch.sigmoid(lin("ir", x) + lin("hr", h))
    z = torch.sigmoid(lin("iz", x) + lin("hz", h))
    n = torch.tanh(lin("in", x) + r * lin("hn", h))
    return (1.0 - z) * n + z * h


def _chain_carry_step(h, xr, xz, xn, ar, az, an, hn_bias, keep):
    f32 = torch.float32
    r = torch.sigmoid(xr.to(f32) + ar.to(f32))
    z = torch.sigmoid(xz.to(f32) + az.to(f32))
    n = torch.tanh(xn.to(f32) + r * (an.to(f32) + hn_bias))
    h2 = (1.0 - z) * n + z * h
    return (h2 if keep is None else torch.where(keep, h2, 0.0)), h2


def _chain_unroll(net, views, features, h0, keep):
    """split_unroll with ``remat`` False as it was (every form gives these
    values)."""
    T = views.shape[0]
    dt, g = net.dtype, net.gru
    x = net.trunk(views.reshape((T * N,) + tuple(views.shape[2:])),
                  features.reshape(T * N, -1)).to(dt)
    cols = {k: (g.get_submodule(k).weight.to(dt).t(), None)
            for k in ("ir", "iz", "in", "hr", "hz", "hn")}
    xr, xz, xn = ((matmul(x, *cols[k]) + g.get_submodule(k).bias.to(dt))
                  .reshape(T, N, H) for k in ("ir", "iz", "in"))
    h, outs = h0, []
    for t in range(T):
        hd = h.to(dt)
        h, out = _chain_carry_step(h, xr[t], xz[t], xn[t],
                                   matmul(hd, *cols["hr"]),
                                   matmul(hd, *cols["hz"]),
                                   matmul(hd, *cols["hn"]), g.hn.bias,
                                   keep[t])
        outs.append(out)
    return net.heads(torch.stack(outs).reshape(T * N, H)).reshape(T, N, -1)


def _net(dtype):
    net = DRQNNet((5, 5, 4), 7, 9, state_size=H, dtype=DTYPES[dtype],
                  generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # biases away from flax's zeros
        for p in net.parameters():
            if p.dim() == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return net


def _window(T=3):
    gen = torch.Generator().manual_seed(6)
    views = torch.rand((T, N, 5, 5, 4), generator=gen)
    feats = torch.rand((T, N, 7), generator=gen)
    h0 = 0.5 * torch.randn((N, H), generator=gen)
    keep = torch.rand((T, N, 1), generator=gen) > 0.3
    return views, feats, h0, keep


def _grads(net, h, out, w):
    net.zero_grad()
    (out * w).sum().backward()
    return [h.grad] + [p.grad for p in net.parameters()]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gru_cell_and_net_on_cpu_are_the_op_chain(dtype):
    net = _net(dtype)
    views, feats, h0, _ = _window()
    x = net.trunk(views[0], feats[0])
    with torch.no_grad():
        assert torch.equal(net.gru(h0, x),
                           _chain_cell(net.gru, h0, x).float())
        got_h, got_q = net(h0, views[0], feats[0])
        want_h = _chain_cell(net.gru, h0, x).float()
        assert torch.equal(got_h, want_h)
        assert torch.equal(got_q, net.heads(want_h))
    if dtype == "f32":
        w = torch.linspace(-1, 1, N * H).reshape(N, H)
        got, want = (_grads(net, h, fn(net.gru, h, x.detach()), w)
                     for fn, h in ((lambda c, h, x: c(h, x),
                                    h0.clone().requires_grad_()),
                                   (_chain_cell, h0.clone().requires_grad_())))
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("remat", [False, "dots", "all"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_unroll_on_cpu_is_the_op_chain(dtype, remat):
    net = _net(dtype)
    views, feats, h0, keep = _window()
    with torch.no_grad():
        want = _chain_unroll(net, views, feats, h0, keep)
        assert torch.equal(split_unroll(net, views, feats, h0, keep=keep,
                                        remat=remat), want)
    if dtype == "bf16":
        return
    w = torch.linspace(-1, 1, want.numel()).reshape(want.shape)
    h = h0.clone().requires_grad_()
    got = _grads(net, h, split_unroll(net, views, feats, h, keep=keep,
                                      remat=remat), w)
    h = h0.clone().requires_grad_()
    ref = _grads(net, h, _chain_unroll(net, views, feats, h, keep), w)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
