"""Per-agent view-window extraction.

The map is rendered once per step into a padded channel image
``[B, Hp, Wp * C]`` (channels contiguous per cell); each agent's
``(vh, vw * C)`` window is the slice at its top-left, times the view-range
mask (reference: Map::extract_view, src/gridworld/Map.cc:129-207).

:func:`window_gather_ref` is the plain PyTorch version (port of
``magent_tpu/ops/window_gather.py`` ``window_gather_xla``);
:func:`window_gather` launches the CUDA kernel of ``csrc/window_gather.cu``
on CUDA tensors and calls the plain version on CPU tensors.  Both take
unpacked positions ``pos = tl_y * Wp + tl_x``.  :func:`window_gather4` (and
its plain version :func:`window_gather4_ref`) adds the fused minimap,
self-mark and liveness epilogue and takes packed positions.
:func:`window_gather_banded` (plain version
:func:`window_gather_banded_ref`) serves images past the JAX package's VMEM
budget: window rows past the image read as zeros, the observation's
epilogue may come along, and its ``unsort=False`` form returns the windows
in the JAX package's band order.  One CUDA kernel template serves all three
(:func:`gather_split`).

Every entry point takes ``out_dtype`` (``torch.float32``, the default, or
``torch.bfloat16``), the JAX kernels' ``out_dtype``: the windows are computed
in f32 and rounded to ``out_dtype`` (to nearest even) at the store, and the
plain versions compute in f32 and call ``.to(out_dtype)`` last.  Each entry
point and dtype has a launch counter of its own (``window_gather`` and
``window_gather_bf16``, ...).
"""

from __future__ import annotations

import torch

from . import _build

# the window kernel's per-value table (offset, mask and, with the minimap,
# mm_mask and minimap cell: up to 16 bytes per value) of a window of at
# most this many f32 bytes stays within a block's shared memory
_MAX_MASK_BYTES = 48 * 1024
# window_gather4's packed positions tl * 1024 + self_cell fit int32 for
# every top-left cell tl of an image of at most this many cells
PACKED_CELLS = 1 << 21
# the band table's chunk: each band's run is padded to whole chunks, so a
# table holds up to n_bands * chunk dummy rows
_MAX_BAND_CHUNK = 128


# the windows' dtypes: the kernels compute in f32 and store in either
OUT_DTYPES = (torch.float32, torch.bfloat16)

# the window kernels' launch split (csrc/window_gather.cu
# window_gather_kernel, every form):
# the call's B*N*vh*vwc output values in 16-byte vectors, cut into spans of
# ``per`` vectors (whole warp tiles of GATHER_TILE), one block of 256
# threads per span.  ``per`` gives every SM GATHER_SPANS_PER_SM spans,
# within [GATHER_MIN_VECS, GATHER_MAX_VECS] (the fastest splits of
# tools/profile_gather.py's table on the H100, battle at B=16 and B=1)
GATHER_TILE = 32
GATHER_SPANS_PER_SM = 4
GATHER_MIN_VECS = 256
GATHER_MAX_VECS = 1024
# the window kernels' image offsets are int32
_MAX_IMAGE = 2**31 - 1


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_out_dtype(name: str, out_dtype) -> None:
    if out_dtype not in OUT_DTYPES:
        raise ValueError("%s: out_dtype must be torch.float32 or "
                         "torch.bfloat16, got %s" % (name, out_dtype))


def _launcher(name: str, out_dtype) -> str:
    """The C launcher of kernel ``name`` that stores ``out_dtype``."""
    return "magent_" + name + ("_bf16" if out_dtype == torch.bfloat16 else "")


def padded_geometry(H: int, W: int, C: int, vh: int, vw: int):
    """Padded image geometry for a (vh, vw, C) window over an (H, W) map,
    equal to the JAX package's (``magent_tpu/ops/window_gather.py``
    padded_geometry), so that both packages render the same image.

    Returns (Hp, Wp, lanes, pad_y, pad_x): the image holds map cell (y, x)
    at image position (y + pad_y, (x + pad_x) * C), and every in-map agent's
    window lies inside it.  ``lanes == Wp * C``.
    """
    pad_y = vh
    pad_x = vw
    rows = _ceil_to(vh + 8 - 1, 8)
    Hp = _ceil_to(H + 2 * pad_y + rows, 8)
    Wp = W + 2 * pad_x
    lanes_load = _ceil_to(vw * C + 128 - 1, 128)
    lanes = _ceil_to(Wp * C, 128) + lanes_load
    Wp = -(-lanes // C)
    lanes = Wp * C
    return Hp, Wp, lanes, pad_y, pad_x


def vec_width(out_dtype) -> int:
    """Values per 16-byte vector of ``out_dtype``: 4 f32 or 8 bf16."""
    return 16 // out_dtype.itemsize


def gather_split(B: int, N: int, E: int, out_dtype, n_sms: int):
    """The 16-byte vectors per span of a window_gather launch over ``B``
    envs of ``N`` windows of ``E = vh * vw * C`` values on a card of
    ``n_sms`` SMs: a multiple of GATHER_TILE (see GATHER_SPANS_PER_SM)."""
    n_vec = -(-B * N * E // vec_width(out_dtype))
    per = n_vec // (GATHER_SPANS_PER_SM * n_sms) // GATHER_TILE * GATHER_TILE
    return min(max(per, GATHER_MIN_VECS), GATHER_MAX_VECS)


def gather_spans(B: int, N: int, E: int, out_dtype, per: int):
    """The value offsets ``[start, end)`` of each span of window_gather's
    flat output, one per block (the Python twin of the kernel's ``e0`` and
    ``n_el``): block g writes vectors ``[g * per, (g + 1) * per)``, cut at
    the call's end."""
    total = B * N * E
    step = per * vec_width(out_dtype)
    return [(s, min(s + step, total)) for s in range(0, total, step)]


def window_gather_ref(gfull, pos, mask, *, vh, vw, C, Wp,
                      out_dtype=torch.float32):
    """Plain version: ``gfull`` [B, Hp, lanes], ``pos`` [B, N] unpacked
    top-left cells, ``mask`` [vh, vw*C] -> [B, N, vh, vw*C] in
    ``out_dtype``."""
    _check_out_dtype("window_gather_ref", out_dtype)
    B = gfull.shape[0]
    y0 = pos.long() // Wp
    x0 = pos.long() % Wp
    oy = torch.arange(vh, device=gfull.device)
    ox = torch.arange(vw * C, device=gfull.device)
    gy = y0[:, :, None, None] + oy[None, None, :, None]
    gl = x0[:, :, None, None] * C + ox[None, None, None, :]
    bidx = torch.arange(B, device=gfull.device)[:, None, None, None]
    return (gfull[bidx, gy, gl] * mask).to(out_dtype)


def window_gather(gfull, pos, mask, *, vh, vw, C, Wp,
                  out_dtype=torch.float32):
    """Window gather: ``gfull`` [B, Hp, lanes] f32, ``pos`` [B, N] int32,
    ``mask`` [vh, vw*C] f32 -> [B, N, vh, vw*C] in ``out_dtype`` (f32 or
    bf16, rounded at the store).  A window that would leave the image
    (``pos`` negative, or too near the bottom or right edge) is written as
    zeros; the plain version indexes past the image there.

    Replaces ``magent_tpu/ops/window_gather.py:79`` ``window_gather`` (the
    Pallas roll kernel, ``pallas_call`` at ``:167``).  Bound on the card:
    bytes — the windows written (75.7 MB of f32 per battle group at B=16,
    37.9 MB of bf16) plus each image value a window reads under a non-zero
    mask entry, once.  Design: ``csrc/window_gather.cu`` — the output as
    one flat run cut into 16-byte vectors, and those into spans, one block
    per span (:func:`gather_split`, :func:`gather_spans`); a warp loads
    tiles of 32 vectors' values lane by lane (coalesced), from shared
    tables of window offsets (with the mask) and agent offsets, and stores
    them through shared memory as one 16-byte vector per lane; every load
    kept, masked or not, so the result equals the plain version bit for
    bit, sign of zero included."""
    _check_out_dtype("window_gather", out_dtype)
    if _build.route(gfull, pos, mask) == "cpu":
        return window_gather_ref(gfull, pos, mask, vh=vh, vw=vw, C=C, Wp=Wp,
                                 out_dtype=out_dtype)
    B, Hp, lanes = gfull.shape
    N = pos.shape[1]
    device = gfull.device
    per = gather_split(B, N, vh * vw * C, out_dtype, _build.sm_count(device))
    return _gather_launch(gfull, pos, mask, vh=vh, vw=vw, C=C, Wp=Wp,
                          out_dtype=out_dtype, per=per)


def _gather_launch(gfull, pos, mask, *, vh, vw, C, Wp, out_dtype, per):
    """The window_gather kernel on CUDA operands in spans of ``per``
    vectors (:func:`gather_split`; a multiple of GATHER_TILE)."""
    B, Hp, lanes = gfull.shape
    N = pos.shape[1]
    vwc = vw * C
    device = gfull.device
    _check_window("window_gather", gfull, mask, vh, vwc)
    _build.check(pos, "window_gather pos", torch.int32, (B, N), device)
    out = torch.empty((B, N, vh, vwc), dtype=out_dtype, device=device)
    if N:
        _build.launch(_launcher("window_gather", out_dtype), device,
                      gfull.data_ptr(), pos.data_ptr(), mask.data_ptr(), B, N,
                      Hp, lanes, Wp, C, vh, vwc, per, out.data_ptr())
    return out


def window_gather4_ref(gfull, pos, mask, mm_img=None, mm_mask=None, act=None,
                       *, vh, vw, C, Wp, out_dtype=torch.float32):
    """Plain version: :func:`window_gather_ref` on the packed positions
    ``pos = tl * 1024 + self_cell``, then the epilogue in the kernel's order:
    ``((view + mm_img) + [cell_id == self_cell] * mm_mask) * act``, in f32,
    rounded to ``out_dtype`` once at the end."""
    _check_out_dtype("window_gather4_ref", out_dtype)
    view = window_gather_ref(gfull, pos >> 10, mask, vh=vh, vw=vw, C=C, Wp=Wp)
    if mm_img is not None:
        # the minimap cell of every window lane: r * vw + c // C
        cell_id = (torch.arange(vh, device=gfull.device)[:, None] * vw
                   + torch.arange(vw * C, device=gfull.device) // C)
        self_mark = (cell_id == (pos & 1023)[..., None, None]).to(view.dtype)
        view = view + mm_img[:, None] + self_mark * mm_mask
    if act is not None:
        view = view * act.to(view.dtype)[..., None, None]
    return view.to(out_dtype)


def window_gather4(gfull, pos, mask, mm_img=None, mm_mask=None, act=None, *,
                   vh, vw, C, Wp, out_dtype=torch.float32):
    """Window gather with a fused epilogue: ``gfull`` [B, Hp, lanes] f32,
    ``pos`` [B, N] int32 packed ``tl * 1024 + self_cell`` (``tl = tl_y * Wp +
    tl_x``, ``self_cell`` the agent's pooled minimap cell, < 1024; the
    image holds at most ``PACKED_CELLS`` cells ``Hp * Wp``), ``mask``
    [vh, vw*C] f32; optional ``act`` [B, N] int32 0/1 liveness, and with
    it optional ``mm_img`` [B, vh, vw*C] f32 pooled minimaps and
    ``mm_mask`` [vh, vw*C] f32 (the minimap channels, which also get the
    +1 self mark) -> [B, N, vh, vw*C] in ``out_dtype`` (f32 or bf16,
    rounded once, after the epilogue).  The minimap comes only with
    ``act``, as the observation's one caller passes it.  A window that
    would leave the image is zeros before the epilogue.

    Replaces ``magent_tpu/ops/window_gather.py:187`` ``window_gather4`` (the
    Pallas replica kernel, ``pallas_call`` at ``:334`` with the epilogue and
    ``:370`` without).  Its four shifted image replicas and SMEM sub-batch
    splits work around the TPU's aligned loads and do not carry over.
    Unlike the TPU kernel, which applies ``act``
    only together with the minimap, the liveness factor stands alone here.
    Bound on the card: bytes, as :func:`window_gather`.  Design:
    ``csrc/window_gather.cu`` ``window_gather_kernel`` in its packed form —
    :func:`window_gather`'s flat spans (:func:`gather_split`), with each
    agent's self cell, liveness and env minimap offset in shared tables
    beside its image offset (a span may cross envs), ``mm_mask`` and the
    minimap cell beside the mask, and the epilogue applied per value, each
    operation rounded on its own, so the result equals the plain version
    bit for bit."""
    _check_out_dtype("window_gather4", out_dtype)
    if (mm_img is None) != (mm_mask is None):
        raise ValueError("window_gather4: mm_img and mm_mask come together")
    if mm_img is not None and act is None:
        raise ValueError("window_gather4: the minimap epilogue comes with act")
    if vh * vw >= 1024:
        raise ValueError("window_gather4: a %dx%d window does not fit the "
                         "10-bit self cell of pos" % (vh, vw))
    if gfull.shape[1] * Wp > PACKED_CELLS:
        raise ValueError("window_gather4: an image of %d x %d cells has top-"
                         "left cells past the 21 bits of pos; use "
                         "window_gather" % (gfull.shape[1], Wp))
    optional = tuple(t for t in (mm_img, mm_mask, act) if t is not None)
    if _build.route(gfull, pos, mask, *optional) == "cpu":
        return window_gather4_ref(gfull, pos, mask, mm_img, mm_mask, act,
                                  vh=vh, vw=vw, C=C, Wp=Wp,
                                  out_dtype=out_dtype)
    B, N = pos.shape
    per = gather_split(B, N, vh * vw * C, out_dtype,
                       _build.sm_count(gfull.device))
    return _gather4_launch(gfull, pos, mask, mm_img, mm_mask, act, vh=vh,
                           vw=vw, C=C, Wp=Wp, out_dtype=out_dtype, per=per)


def _check_window(name, gfull, mask, vh, vwc, extra_rows=0):
    """The checks every window kernel shares: the image f32 [B, Hp,
    lanes] with int32 offsets (``extra_rows`` more rows of them), the mask
    [vh, vwc] f32 within the kernel's table."""
    B, Hp, lanes = gfull.shape
    device = gfull.device
    _build.check(gfull, name + " image", torch.float32, (B, Hp, lanes),
                 device)
    _build.check(mask, name + " mask", torch.float32, (vh, vwc), device)
    if vh * vwc * 4 > _MAX_MASK_BYTES:
        raise ValueError("window %dx%d too large for the kernel's tables"
                         % (vh, vwc))
    if (B * Hp + extra_rows) * lanes > _MAX_IMAGE:
        raise ValueError("%s: an image of %d values has offsets past int32"
                         % (name, B * Hp * lanes))


def _gather4_launch(gfull, pos, mask, mm_img, mm_mask, act, *, vh, vw, C, Wp,
                    out_dtype, per):
    """The packed form of the window kernel on CUDA operands in spans of
    ``per`` vectors (:func:`gather_split`; a multiple of GATHER_TILE)."""
    B, Hp, lanes = gfull.shape
    N = pos.shape[1]
    vwc = vw * C
    device = gfull.device
    _check_window("window_gather4", gfull, mask, vh, vwc)
    _build.check(pos, "window_gather4 pos", torch.int32, (B, N), device)
    if mm_img is not None:
        _build.check(mm_img, "window_gather4 mm_img", torch.float32,
                     (B, vh, vwc), device)
        _build.check(mm_mask, "window_gather4 mm_mask", torch.float32,
                     (vh, vwc), device)
    if act is not None:
        _build.check(act, "window_gather4 act", torch.int32, (B, N), device)
    out = torch.empty((B, N, vh, vwc), dtype=out_dtype, device=device)
    if N:
        _build.launch(_launcher("window_gather4", out_dtype), device,
                      gfull.data_ptr(), pos.data_ptr(), mask.data_ptr(),
                      _ptr(mm_img), _ptr(mm_mask), _ptr(act), B, N, Hp,
                      lanes, Wp, C, vh, vw, per, out.data_ptr())
    return out


def _ptr(t):
    """A kernel's optional operand: its data pointer, or NULL."""
    return None if t is None else t.data_ptr()


def window_epilogue(view, act, mm=None, self_cell=None, mm_maskc=None):
    """The observation's epilogue: ``((view + mm) + self mark * mm_maskc) *
    act`` over [B, n, vh, vw, C] windows, in the JAX package's order
    (magent_tpu/core/observe.py:394-400); without ``mm``, the liveness
    factor alone.  ``mm`` [B, vh, vw, C] pooled minimaps, ``self_cell``
    [B, n] each agent's minimap cell, ``mm_maskc`` [C] the minimap
    channels.  bf16 windows promote to f32 where an f32 operand joins them,
    as in the JAX package."""
    if mm is not None:
        vh, vw = view.shape[2:4]
        self_mark = (self_cell[..., None] == torch.arange(
            vh * vw, device=view.device)).to(torch.float32)
        view = (view + mm[:, None]
                + self_mark.reshape(view.shape[:-1])[..., None] * mm_maskc)
    return view * act[:, :, None, None, None]


# ---------------------------------------------------------------- banded
def banded_tables(pos, *, Wp, band_rows, n_bands, chunk):
    """Band sort and per-band chunk padding of :func:`window_gather_banded`
    (the JAX package's ``banded_tables``): ``pos`` [B, N] unpacked top-left
    cells -> (``pos_pad`` [B, n_pad] the positions in band order, each
    band's run padded to whole chunks with dummies that point at the band's
    first row; ``chunk_band`` [B, n_chunks] the band of every chunk;
    ``inv`` [B, N] the row of ``pos_pad`` that holds each slot's window).
    ``n_pad = ceil(N / chunk) * chunk + n_bands * chunk``.  The sort is
    stable: agents of one band keep their slot order."""
    B, N = pos.shape
    device = pos.device
    band = pos.long() // (Wp * band_rows)
    s_band, s_slot = torch.sort(band, dim=1, stable=True)
    s_pos = torch.gather(pos, 1, s_slot)
    counts = torch.zeros((B, n_bands), dtype=torch.int64,
                         device=device).scatter_add_(
        1, s_band, torch.ones_like(s_band))
    padded = (counts + chunk - 1) // chunk * chunk
    pad_off = padded.cumsum(1) - padded
    start = counts.cumsum(1) - counts
    rank = torch.arange(N, device=device) - torch.gather(start, 1, s_band)
    dest = torch.gather(pad_off, 1, s_band) + rank
    n_pad = _ceil_to(N, chunk) + n_bands * chunk
    n_chunks = n_pad // chunk
    chunk_starts = (torch.arange(n_chunks, device=device) * chunk).expand(
        B, n_chunks).contiguous()
    # the band whose padded run holds chunk k: the last band whose offset
    # is at most k * chunk
    chunk_band = (torch.searchsorted(pad_off, chunk_starts, right=True) - 1
                  ).clamp(0, n_bands - 1)
    pos_pad = (chunk_band * (band_rows * Wp))[:, :, None].expand(
        B, n_chunks, chunk).reshape(B, n_pad).to(torch.int32)
    pos_pad = pos_pad.scatter(1, dest, s_pos)
    inv = torch.empty((B, N), dtype=torch.int64, device=device).scatter_(
        1, s_slot, dest)
    return pos_pad, chunk_band.to(torch.int32), inv.to(torch.int32)


def _band_geometry(Hp, vh, band_rows):
    """(n_bands, rows below a band that its windows may reach)."""
    if band_rows % 8:
        raise ValueError("band_rows must be a multiple of 8, got %d"
                         % band_rows)
    return -(-Hp // band_rows), _ceil_to(vh + 8 - 1, 8)


def _unsort(out, inv):
    """Windows in band order [B, n_pad, vh, vwc] -> slot order, by one row
    gather of the flattened windows."""
    B, n_pad, vh, vwc = out.shape
    N = inv.shape[1]
    flat = out.reshape(B, n_pad, vh * vwc)
    return torch.gather(flat, 1, inv.long()[:, :, None].expand(
        B, N, vh * vwc)).reshape(B, N, vh, vwc)


def _check_banded(chunk, unsort, act, mm, self_cell, mm_maskc):
    if not 0 < chunk <= _MAX_BAND_CHUNK:
        raise ValueError("window_gather_banded: chunk must be in 1..%d, got "
                         "%d" % (_MAX_BAND_CHUNK, chunk))
    minimap = [t is not None for t in (mm, self_cell, mm_maskc)]
    if any(minimap) and not all(minimap):
        raise ValueError("window_gather_banded: mm, self_cell and mm_maskc "
                         "come together")
    if mm is not None and act is None:
        raise ValueError("window_gather_banded: the minimap epilogue comes "
                         "with act")
    if act is not None and not unsort:
        raise ValueError("window_gather_banded: the epilogue applies to the "
                         "windows in slot order (unsort=True)")


def window_gather_banded_ref(gfull, pos, mask, *, vh, vw, C, Wp, chunk=40,
                             band_rows=32, unsort=True,
                             out_dtype=torch.float32, act=None, mm=None,
                             self_cell=None, mm_maskc=None):
    """Plain version: :func:`banded_tables`, then :func:`window_gather_ref`
    over the band-ordered table on the image padded with zero rows below,
    as the JAX kernel reads its bands, rounded to ``out_dtype``;
    ``unsort`` undoes the band order; with ``act``, then
    :func:`window_epilogue` in f32 (liveness as f32) and a second rounding
    to ``out_dtype``, as the JAX package's observation does after its
    kernel (magent_tpu/core/observe.py:378-401)."""
    _check_out_dtype("window_gather_banded_ref", out_dtype)
    _check_banded(chunk, unsort, act, mm, self_cell, mm_maskc)
    B, Hp, lanes = gfull.shape
    n_bands, rows = _band_geometry(Hp, vh, band_rows)
    pos_pad, _, inv = banded_tables(pos, Wp=Wp, band_rows=band_rows,
                                    n_bands=n_bands, chunk=chunk)
    gpad = torch.nn.functional.pad(
        gfull, (0, 0, 0, n_bands * band_rows + rows - Hp))
    out = window_gather_ref(gpad, pos_pad, mask, vh=vh, vw=vw, C=C, Wp=Wp,
                            out_dtype=out_dtype)
    if not unsort:
        return out, inv
    view = _unsort(out, inv)
    if act is None:
        return view
    N = pos.shape[1]
    return window_epilogue(view.reshape(B, N, vh, vw, C),
                           act.to(torch.float32), mm, self_cell,
                           mm_maskc).to(out_dtype).reshape(B, N, vh, vw * C)


def window_gather_banded(gfull, pos, mask, *, vh, vw, C, Wp, chunk=40,
                         band_rows=32, unsort=True, out_dtype=torch.float32,
                         act=None, mm=None, self_cell=None, mm_maskc=None):
    """Window gather of the banded route: ``gfull`` [B, Hp, lanes] f32,
    ``pos`` [B, N] int32 unpacked top-left cells, ``mask`` [vh, vw*C] f32
    -> [B, N, vh, vw*C] windows in slot order, in ``out_dtype`` (f32 or
    bf16, rounded at the store); window rows past the image read as zeros,
    and a window at a negative position or leaving the image on the right
    is zeros.  With ``unsort=False`` the windows in band order [B, n_pad,
    vh, vw*C] and ``inv`` [B, N] int32 (slot n's window is row ``inv[b,
    n]``; dummy rows hold the window at their band's first row), as the
    JAX package's function returns them.

    With ``unsort=True`` the observation's epilogue may come along:
    ``act`` [B, N] int32 0/1 liveness, and with it ``mm`` [B, vh, vw, C]
    f32 pooled minimaps, ``self_cell`` [B, N] int32 minimap cells and
    ``mm_maskc`` [C] f32 minimap channels.  The windows are rounded to
    ``out_dtype``, :func:`window_epilogue` runs on them in f32, and the
    result is rounded again: what the JAX package's observation computes
    after its banded kernel (magent_tpu/core/observe.py:378-401).

    Replaces ``magent_tpu/ops/window_gather.py:477`` ``window_gather_banded``
    (``pallas_call`` at ``:543``), which the JAX package runs for images
    above its VMEM budget (pursuit from map 500).  Its band sort, its
    ``banded_pack`` slab copy and SMEM split of the launch keep a band in
    VMEM and do not carry over: the image (22.6 MB at pursuit map 1000)
    stays in the H100's L2, and the kernel writes each window straight to
    its slot.  Bound on the card: bytes — the windows written and the
    image read once (pursuit at map 1000: 30.3 and 40.5 MB of f32 windows
    from a 22.6 MB image).  Design: ``csrc/window_gather.cu``
    ``window_gather_kernel`` in its banded form — :func:`window_gather`'s
    flat spans with the env image's end beside each agent's offset (one
    compare per value zeroes rows past the image) and the epilogue's
    operands as in :func:`window_gather4`; exact against the plain
    version.  The band-ordered form builds :func:`banded_tables` in
    PyTorch and runs the same kernel over ``pos_pad``."""
    _check_out_dtype("window_gather_banded", out_dtype)
    _check_banded(chunk, unsort, act, mm, self_cell, mm_maskc)
    epi = dict(act=act, mm=mm, self_cell=self_cell, mm_maskc=mm_maskc)
    optional = tuple(t for t in epi.values() if t is not None)
    if _build.route(gfull, pos, mask, *optional) == "cpu":
        return window_gather_banded_ref(gfull, pos, mask, vh=vh, vw=vw, C=C,
                                        Wp=Wp, chunk=chunk,
                                        band_rows=band_rows, unsort=unsort,
                                        out_dtype=out_dtype, **epi)
    B, Hp, lanes = gfull.shape
    n_bands, _ = _band_geometry(Hp, vh, band_rows)
    geo = dict(vh=vh, vw=vw, C=C, Wp=Wp, out_dtype=out_dtype)
    if unsort:
        return _banded_launch(gfull, pos, mask, **geo, **epi)
    _build.check(pos, "window_gather_banded pos", torch.int32,
                 (B, pos.shape[1]), gfull.device)
    pos_pad, _, inv = banded_tables(pos, Wp=Wp, band_rows=band_rows,
                                    n_bands=n_bands, chunk=chunk)
    return _banded_launch(gfull, pos_pad, mask, **geo), inv


def _banded_launch(gfull, pos, mask, *, vh, vw, C, Wp,
                   out_dtype=torch.float32, per=None, act=None, mm=None,
                   self_cell=None, mm_maskc=None):
    """The banded form of the window kernel on CUDA operands: ``pos`` [B,
    N] the slot-order positions (or a band table's ``pos_pad``) -> windows
    [B, N, vh, vw*C] in ``out_dtype``, with the epilogue of the operands
    given; in spans of ``per`` vectors (default: :func:`gather_split`)."""
    _check_out_dtype("window_gather_banded", out_dtype)
    B, Hp, lanes = gfull.shape
    N = pos.shape[1]
    vwc = vw * C
    device = gfull.device
    # a window's rows reach vh rows past its env's image before the
    # kernel's row test zeroes them
    _check_window("window_gather_banded", gfull, mask, vh, vwc, vh)
    _build.check(pos, "window_gather_banded pos", torch.int32, (B, N), device)
    if act is not None:
        _build.check(act, "window_gather_banded act", torch.int32, (B, N),
                     device)
    if mm is not None:
        _build.check(mm, "window_gather_banded mm", torch.float32,
                     (B, vh, vw, C), device)
        _build.check(self_cell, "window_gather_banded self_cell", torch.int32,
                     (B, N), device)
        _build.check(mm_maskc, "window_gather_banded mm_maskc", torch.float32,
                     (C,), device)
    if per is None:
        per = gather_split(B, N, vh * vwc, out_dtype, _build.sm_count(device))
    out = torch.empty((B, N, vh, vwc), dtype=out_dtype, device=device)
    if N:
        _build.launch(_launcher("window_gather_banded", out_dtype), device,
                      gfull.data_ptr(), pos.data_ptr(), mask.data_ptr(),
                      _ptr(mm), _ptr(mm_maskc), _ptr(act), _ptr(self_cell),
                      B, N, Hp, lanes, Wp, C, vh, vw, per, out.data_ptr())
    return out
