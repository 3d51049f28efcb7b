"""The GRU cell's gate math on the card: everything between the six
projections and the new state as one launch of ``csrc/gru_cell.cu``, and
its backward as one more.

The cell is flax's ``GRUCell`` (:mod:`~..builtin.torch_model.drqn`): ``r =
sigmoid(xr + ar)``, ``z = sigmoid(xz + az)``, ``n = tanh(xn + r * an)``,
``h' = (1 - z) * n + z * h``, with ``x*`` the input's projections and
``a*`` the state's (``[N, H]`` each, in the net's dtype), ``h`` the f32
state.  Two forms, fixed by the caller:

- :func:`gru_cell`, the acting cell (``GRUCell``): the whole cell in the
  net's dtype, rounded where PyTorch's ops in that dtype round; ``h'``
  widened to the state's f32, which ``DRQNNet`` carries and its heads
  read;
- :func:`gru_carry`, :func:`~..builtin.torch_model.drqn.split_unroll`'s
  carry step: the gates in f32 over the dtype's projections, ``an`` plus
  hn's f32 bias, the reset ``keep`` fused -> (the f32 carry, the f32
  output, the carry in the dtype for the next step's state matmuls).

On CPU tensors both run the plain op chain (:func:`gru_cell_ref`) under
autograd; on CUDA tensors :class:`GRUCellFunction`, whose forward and
backward are the kernels (the backward recomputes the gates from the saved
projections and state, :func:`gru_cell_backward`), or they raise.
:func:`gru_cell_backward_ref` is the hand-derived backward in plain
PyTorch, the backward kernel's plain version, which the Function runs on
CPU tensors."""

from __future__ import annotations

import torch

from . import _build

# csrc/gru_cell.cu Form
ACT, CARRY = 0, 1
THREADS, VEC = 256, 8
# the grid-stride loop's blocks per SM at most: a cell of 102,400 x 512
# runs 24 vectors of 8 values per thread
BLOCKS_PER_SM = 8


def gru_cell_ref(form, h, xr, xz, xn, ar, az, an, hn_bias=None, keep=None):
    """The cell as PyTorch ops.  ``ACT``: ``h'`` widened to ``h``'s dtype,
    every op in the projections' dtype.  ``CARRY`` -> (carry,
    output, carry in the projections' dtype), the gates in ``h``'s dtype:
    ``an`` plus ``hn_bias``, the carry ``h'`` where ``keep`` ([N, 1] bool,
    None: everywhere) else 0."""
    dt = xr.dtype
    if form == ACT:
        hd = h.to(dt)
        r = torch.sigmoid(xr + ar)
        z = torch.sigmoid(xz + az)
        n = torch.tanh(xn + r * an)
        h2 = (1.0 - z) * n + z * hd
        return h2.to(h.dtype)
    w = h.dtype
    r = torch.sigmoid(xr.to(w) + ar.to(w))
    z = torch.sigmoid(xz.to(w) + az.to(w))
    n = torch.tanh(xn.to(w) + r * (an.to(w) + hn_bias))
    h2 = (1.0 - z) * n + z * h
    carry = h2 if keep is None else torch.where(keep, h2, 0.0)
    return carry, h2, carry.to(dt)


def gru_cell_backward_ref(form, h, xr, xz, xn, ar, az, an, hn_bias, keep,
                          g, g_out=None, g_dt=None):
    """The kernel's backward in plain PyTorch: the gates recomputed at the
    forward's rounding points, every gradient in ``h``'s dtype, of ``h'``
    (``ACT``: ``g``) or of the carry (``g``), the output (``g_out``) and
    the carry in the dtype (``g_dt``), each None for zeros (``CARRY``).
    -> (r's, z's, in's and hn's pre-activation gradients in the
    projections' dtype, the state's direct gradient in ``h``'s dtype,
    hn's in ``h``'s dtype)."""
    dt, w = xr.dtype, h.dtype
    if form == ACT:
        def rd(t):
            return t.to(dt).to(w)
        an = an.to(w)
        d = g.to(w)
    else:
        def rd(t):
            return t
        an = an.to(w) + hn_bias
        d = torch.zeros_like(h)
        for part in (g, g_dt):
            if part is not None:
                d = d + part.to(w)
        if keep is not None:
            d = torch.where(keep, d, 0.0)
        if g_out is not None:
            d = g_out + d
    hd = rd(h)
    r = rd(torch.sigmoid(rd(xr.to(w) + ar.to(w))))
    z = rd(torch.sigmoid(rd(xz.to(w) + az.to(w))))
    n = rd(torch.tanh(rd(xn.to(w) + rd(r * an))))
    omz = rd(1.0 - z)
    d_n = d * omz
    d_z = d * hd - d * n
    d_sn = d_n * (1.0 - n * n)
    d_hn = d_sn * r
    d_r = (d_sn * an) * (1.0 - r) * r
    d_z = d_z * (1.0 - z) * z
    return (d_r.to(dt), d_z.to(dt), d_sn.to(dt), d_hn.to(dt), d * z, d_hn)


def _blocks(n_vecs: int, device) -> int:
    return max(1, min(-(-n_vecs // THREADS),
                      _build.sm_count(device) * BLOCKS_PER_SM))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(form, h, projections, hn_bias, keep):
    """Validate the kernel's operands -> (device, N, H, dtype)."""
    device, (N, H), dt = h.device, tuple(h.shape), projections[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError("gru_cell: projections must be float32 or bfloat16, "
                         "got %s" % dt)
    if H % VEC:
        raise ValueError("gru_cell: the state width %d is not a multiple of "
                         "%d" % (H, VEC))
    _build.check(h, "gru_cell h", torch.float32, (N, H), device)
    for i, t in enumerate(projections):
        _build.check(t, "gru_cell projection %d" % i, dt, (N, H), device)
    if form == CARRY:
        _build.check(hn_bias, "gru_cell hn_bias", torch.float32, (H,), device)
        if keep is not None:
            _build.check(keep, "gru_cell keep", torch.bool, (N, 1), device)
    for t in (h, *projections, hn_bias):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("gru_cell: operands must be 16-byte aligned")
    return device, N, H, dt


def _forward(form, h, xr, xz, xn, ar, az, an, hn_bias, keep):
    proj = (xr, xz, xn, ar, az, an)
    if _build.route(h, *proj) == "cpu":
        out = gru_cell_ref(form, h, *proj, hn_bias, keep)
        # three distinct tensors, as the kernel writes them
        return out if form == ACT else (out[0].clone(), out[1],
                                        out[2].clone())
    device, N, H, dt = _check(form, h, proj, hn_bias, keep)
    bf16 = dt == torch.bfloat16
    if form == ACT:
        out = torch.empty((N, H), dtype=torch.float32, device=device)
        outs, extra = (out,), (None, None)
    else:
        carry, h2 = (torch.empty((N, H), dtype=torch.float32, device=device)
                     for _ in range(2))
        carry_dt = torch.empty((N, H), dtype=dt, device=device)
        outs, extra = (carry, h2, carry_dt), (h2.data_ptr(),
                                              carry_dt.data_ptr())
    _build.launch("magent_gru_cell", device, form, int(bf16), N, H, h.data_ptr(), *(t.data_ptr() for t in proj),
                  _ptr(hn_bias), _ptr(keep), outs[0].data_ptr(), *extra,
                  _blocks(N * H // VEC, device))
    return outs[0] if form == ACT else outs


def gru_cell_backward(form, h, xr, xz, xn, ar, az, an, hn_bias, keep, g,
                      g_out, g_dt, want_hn32):
    """The backward of ``form`` on its operands and incoming gradients (as
    :func:`gru_cell_backward_ref` takes them) -> (r's, z's, in's, hn's
    gradients in the projections' dtype, the state's direct one in f32,
    hn's in f32 where the dtype is f32 or ``want_hn32`` asks, else None):
    one kernel launch on the card, the plain version on the CPU."""
    proj = (xr, xz, xn, ar, az, an)
    if _build.route(h, *proj) == "cpu":
        return gru_cell_backward_ref(form, h, *proj, hn_bias, keep, g, g_out,
                                     g_dt)
    device, N, H, dt = _check(form, h, proj, hn_bias, keep)
    grads = []
    for name, t, want in zip(("g", "g_out", "g_dt"), (g, g_out, g_dt),
                             (torch.float32, torch.float32, dt)):
        if t is not None:
            t = t.contiguous()
            if t.data_ptr() % 16:
                raise ValueError("gru_cell: gradient %s must be 16-byte "
                                 "aligned" % name)
            _build.check(t, "gru_cell " + name, want, (N, H), device)
        grads.append(t)
    g, g_out, g_dt = grads
    gr, gz, gn, ghn = (torch.empty((N, H), dtype=dt, device=device)
                       for _ in range(4))
    gh = torch.empty((N, H), dtype=torch.float32, device=device)
    if dt == torch.float32 or form == ACT or not want_hn32:
        ghn32 = ghn if dt == torch.float32 else None
        ptr32 = None
    else:
        ghn32 = torch.empty((N, H), dtype=torch.float32, device=device)
        ptr32 = ghn32.data_ptr()
    _build.launch("magent_gru_cell_backward", device, form,
                  int(dt == torch.bfloat16), N, H, h.data_ptr(),
                  *(t.data_ptr() for t in proj), _ptr(hn_bias), _ptr(keep),
                  _ptr(g), _ptr(g_out), _ptr(g_dt), gr.data_ptr(),
                  gz.data_ptr(), gn.data_ptr(), ghn.data_ptr(), gh.data_ptr(),
                  ptr32, _blocks(N * H // VEC, device))
    return gr, gz, gn, ghn, gh, ghn32


class GRUCellFunction(torch.autograd.Function):
    """``apply(form, h, xr, xz, xn, ar, az, an, hn_bias, keep)``:
    the cell of ``form`` with the kernels' backward; saves only its
    operands.  ``CARRY`` gives three outputs; a gradient that never
    arrives is read as zeros."""

    @staticmethod
    def forward(ctx, form, h, xr, xz, xn, ar, az, an, hn_bias, keep):
        ctx.set_materialize_grads(False)
        ctx.form = form
        ctx.save_for_backward(h, xr, xz, xn, ar, az, an, hn_bias, keep)
        return _forward(form, h, xr, xz, xn, ar, az, an, hn_bias, keep)

    @staticmethod
    def backward(ctx, *grads):
        h, xr, xz, xn, ar, az, an, hn_bias, keep = ctx.saved_tensors
        form = ctx.form
        g, g_out, g_dt = grads if form == CARRY else (grads[0], None, None)
        if g is None and g_out is None and g_dt is None:
            return (None,) * 10
        want_bias = form == CARRY and ctx.needs_input_grad[8]
        gr, gz, gn, ghn, gh, ghn32 = gru_cell_backward(
            form, h, xr, xz, xn, ar, az, an, hn_bias, keep, g, g_out, g_dt,
            want_bias)
        bias = ghn32.sum(0) if want_bias else None
        return (None, gh, gr, gz, gn, gr, gz, ghn, bias, None)


def gru_cell(h, xr, xz, xn, ar, az, an):
    """The acting cell: ``h'`` ``[N, H]`` in the projections' dtype,
    widened to f32."""
    if _build.route(h, xr, xz, xn, ar, az, an) == "cpu":
        return gru_cell_ref(ACT, h, xr, xz, xn, ar, az, an)
    return GRUCellFunction.apply(ACT, h, xr, xz, xn, ar, az, an, None, None)


def gru_carry(h, xr, xz, xn, ar, az, an, hn_bias, keep=None):
    """The carry step -> (carry f32, output f32, carry in the projections'
    dtype)."""
    if _build.route(h, xr, xz, xn, ar, az, an, hn_bias) == "cpu":
        return gru_cell_ref(CARRY, h, xr, xz, xn, ar, az, an, hn_bias, keep)
    return GRUCellFunction.apply(CARRY, h, xr, xz, xn, ar, az, an, hn_bias,
                                 keep)
