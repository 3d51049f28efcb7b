"""The window-gather cost ladder: stripped variants of the replica window
kernel, each adding one cost component, for measurement only.

Port of ``scripts/profile_window.py`` ``ladder`` and ``shared_tile``.  The
TPU kernel aligns every window load to a (16, 128) tile of one of four
image replicas (shifted by 0 or 4 rows and 0 or 64 lanes) and rolls the
residual into place; the ladder builds that kernel up one component at a
time.  The values are the script's, defined here without the replicas:
replica ``rep = 2 * sel_r + sel_l`` read at ``(r, l)`` is
``gfull[b, r + 4 * sel_r, l + 64 * sel_l]``, zero past the image.

=========  ==============================================================
``floor``  1.0
``smem``   ``float(rep + y8 + l128 + rry + rrl)`` (the unpacked words)
``load``   the replica's (vh, vw*C) corner at ``(y8, l128)``
``roll1``  ``load`` with rows shifted by ``ry' = ry - 4 * sel_r``
``roll2``  ``roll1`` with lanes shifted by ``rl' = rl - 64 * sel_l``:
           the true window
``mask``   ``roll2 * mask``, equal to :func:`window_gather.window_gather4`
           without an epilogue
=========  ==============================================================

:func:`shared_tile` applies each agent's residuals to the tile corner of
the first agent of its chunk, ``(n // chunk) * chunk`` of its own env.  The
script indexes its words at ``b * n_pad + n`` while it passes the unpadded
``[B, N]`` words, so for ``N % chunk != 0`` every env after the first reads
other agents' words; here each env indexes its own.

:func:`ladder_ref` and :func:`shared_tile_ref` are the plain versions;
:func:`ladder` and :func:`shared_tile` pack the words with
:func:`precompute` and pass them to :func:`ladder_packed` and
:func:`shared_tile_packed`, which launch ``csrc/window_ladder.cu`` on CUDA
tensors and call the plain versions on CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build

LEVELS = ("floor", "smem", "load", "roll1", "roll2", "mask")
_LEVEL_CODE = {name: k for k, name in enumerate(LEVELS)}
# the TPU kernel's aligned load tile and its replica lane shift
ROWS, LANES, MINOR = 16, 128, 64
# a window fits its tile after the largest residual shift (3 rows, 63 lanes)
MAX_VH = ROWS - 3
MAX_VWC = LANES - (MINOR - 1)
# the packed word's fields: y8 in 14 bits, l128 in 15
MAX_HP, MAX_LANES = 1 << 14, 1 << 15


def precompute(pos, *, Wp, C):
    """The script's packed words of unpacked top-left cells ``pos`` [B, N]
    int32: ``word = rep << 29 | y8 << 15 | l128`` and ``aux = rry << 17 |
    rrl << 10``, both int32 [B, N]."""
    p = pos.long()
    yy = p // Wp
    lane = (p % Wp) * C
    y8 = yy // 8 * 8
    l128 = lane // LANES * LANES
    ry = yy - y8
    rl = lane - l128
    sel_r = (ry >= 4).long()
    sel_l = (rl >= MINOR).long()
    rep = sel_r * 2 + sel_l
    rry = (ROWS - (ry - sel_r * 4)) % ROWS
    rrl = (LANES - (rl - sel_l * MINOR)) % LANES
    word = (rep << 29) | (y8 << 15) | l128
    aux = (rry << 17) | (rrl << 10)
    return word.to(torch.int32), aux.to(torch.int32)


def _unpack(word, aux):
    """The fields the kernels read, masked to their widths so that any
    int32 words give in-range rows and lanes: (rep, y8, l128, rry, rrl)."""
    w, x = word.long(), aux.long()
    return ((w >> 29) & 3, (w >> 15) & 0x3FFF, w & 0x7FFF, (x >> 17) & 0xF,
            (x >> 10) & 0x7F)


def _replica_corner(rep, y8, l128):
    """The image row and lane of the replica's aligned tile corner."""
    return y8 + 4 * (rep >> 1), l128 + MINOR * (rep & 1)


def _residuals(rry, rrl):
    """The residual row and lane shifts ``ry'``, ``rl'`` undone by the
    rolls."""
    return (ROWS - rry) % ROWS, (LANES - rrl) % LANES


def _windows(gfull, row, lane, vh, vwc):
    """``gfull[b, row + r, lane + c]`` for r < vh, c < vwc, zero past the
    image: [B, N, vh, vwc]."""
    B, Hp, L = gfull.shape
    dev = gfull.device
    R = row[:, :, None, None] + torch.arange(vh, device=dev)[:, None]
    Lc = lane[:, :, None, None] + torch.arange(vwc, device=dev)
    inside = (R < Hp) & (Lc < L)
    b = torch.arange(B, device=dev)[:, None, None, None]
    got = gfull[b, R.clamp(max=Hp - 1), Lc.clamp(max=L - 1)]
    return torch.where(inside, got, torch.zeros((), device=dev))


def ladder_ref(gfull, pos, mask, *, level, chunk, vh, vw, C, Wp):
    """Plain version of :func:`ladder` (``chunk`` does not change the
    values: it is the TPU kernel's unroll)."""
    del chunk
    return _ladder_plain(gfull, *precompute(pos, Wp=Wp, C=C), mask,
                         level=level, vh=vh, vwc=vw * C)


def shared_tile_ref(gfull, pos, mask, *, chunk, vh, vw, C, Wp):
    """Plain version of :func:`shared_tile`."""
    return _shared_tile_plain(gfull, *precompute(pos, Wp=Wp, C=C), mask,
                              chunk=chunk, vh=vh, vwc=vw * C)


def _ladder_plain(gfull, word, aux, mask, *, level, vh, vwc):
    """The ladder level ``level`` on the packed words of :func:`precompute`
    (plain PyTorch)."""
    rep, y8, l128, rry, rrl = _unpack(word, aux)
    B, N = word.shape
    if level == "floor":
        return torch.ones((B, N, vh, vwc), device=gfull.device)
    if level == "smem":
        val = (rep + y8 + l128 + rry + rrl).to(torch.float32)
        return val[:, :, None, None].expand(B, N, vh, vwc).contiguous()
    row, lane = _replica_corner(rep, y8, l128)
    dr, dl = _residuals(rry, rrl)
    if level != "load":
        row = row + dr
    if level in ("roll2", "mask"):
        lane = lane + dl
    out = _windows(gfull, row, lane, vh, vwc)
    return out * mask if level == "mask" else out


def _shared_tile_plain(gfull, word, aux, mask, *, chunk, vh, vwc):
    """:func:`shared_tile` on the packed words of :func:`precompute` (plain
    PyTorch)."""
    rep, y8, l128, rry, rrl = _unpack(word, aux)
    first = torch.arange(word.shape[1], device=word.device) // chunk * chunk
    row, lane = _replica_corner(rep[:, first], y8[:, first], l128[:, first])
    dr, dl = _residuals(rry, rrl)
    return _windows(gfull, row + dr, lane + dl, vh, vwc) * mask


def _check(name, gfull, word, aux, mask, vh, vwc):
    """Operand checks of both wrappers on the CUDA route."""
    B, Hp, lanes = gfull.shape
    device = gfull.device
    _build.check(gfull, name + " image", torch.float32, (B, Hp, lanes), device)
    N = word.shape[-1]
    _build.check(word, name + " word", torch.int32, (B, N), device)
    _build.check(aux, name + " aux", torch.int32, (B, N), device)
    _build.check(mask, name + " mask", torch.float32, (vh, vwc), device)
    if B > 65535:
        raise ValueError("%s: at most 65535 envs per launch" % name)


def _check_geometry(name, gfull, chunk, vh, vw, C):
    """The checks both routes make: the window fits the TPU tile after its
    residual shifts, the image fits the packed word, chunk is positive."""
    if not 0 < vh <= MAX_VH or not 0 < vw * C <= MAX_VWC:
        raise ValueError("%s: a %d x %d window does not fit the %d x %d tile "
                         "after its residual shifts (at most %d x %d)"
                         % (name, vh, vw * C, ROWS, LANES, MAX_VH, MAX_VWC))
    if gfull.shape[1] > MAX_HP or gfull.shape[2] > MAX_LANES:
        raise ValueError("%s: an image of %d x %d does not fit the packed "
                         "word (at most %d x %d)" % (
                             name, gfull.shape[1], gfull.shape[2], MAX_HP,
                             MAX_LANES))
    if chunk <= 0:
        raise ValueError("%s: chunk must be positive, got %d" % (name, chunk))


def ladder(gfull, pos, mask, *, level, chunk, vh, vw, C, Wp):
    """One ladder level: ``gfull`` [B, Hp, lanes] f32, ``pos`` [B, N] int32
    unpacked top-left cells, ``mask`` [vh, vw*C] f32 -> [B, N, vh, vw*C]
    f32 (the table in the module docstring): :func:`ladder_packed` on the
    words of :func:`precompute`.

    Replaces ``scripts/profile_window.py:111`` ``ladder`` (``pallas_call``
    at ``:159``).  Bound on the card: bytes — the windows written (110.8
    MB at the script's geometry) and, from ``load`` up, the image read
    (23.1 MB).  Design: ``csrc/window_ladder.cu`` — the layout of
    ``window_gather4_kernel`` (one block per 32-agent chunk and env, a warp
    per window row), each level adding one component of its cost.  The
    words are computed by :func:`precompute` in PyTorch; a pure copy, so
    the result equals the plain version exactly."""
    return ladder_packed(gfull, *precompute(pos, Wp=Wp, C=C), mask,
                         level=level, chunk=chunk, vh=vh, vw=vw, C=C)


def ladder_packed(gfull, word, aux, mask, *, level, chunk, vh, vw, C):
    """:func:`ladder` on the packed words ``word``, ``aux`` [B, N] int32 of
    :func:`precompute`, which the TPU kernel gets by scalar prefetch: the
    kernel alone on CUDA tensors, its plain version on CPU tensors."""
    if level not in LEVELS:
        raise ValueError("ladder: level must be one of %s, got %r"
                         % (LEVELS, level))
    _check_geometry("ladder", gfull, chunk, vh, vw, C)
    vwc = vw * C
    if _build.route(gfull, word, aux, mask) == "cpu":
        return _ladder_plain(gfull, word, aux, mask, level=level, vh=vh,
                             vwc=vwc)
    _check("ladder", gfull, word, aux, mask, vh, vwc)
    B, Hp, lanes = gfull.shape
    N = word.shape[1]
    out = torch.empty((B, N, vh, vwc), dtype=torch.float32,
                      device=gfull.device)
    if N:
        _build.launch("magent_window_ladder", gfull.device, gfull.data_ptr(),
                      word.data_ptr(), aux.data_ptr(), mask.data_ptr(),
                      _LEVEL_CODE[level], B, N, Hp, lanes, vh, vwc,
                      out.data_ptr())
    return out


def shared_tile(gfull, pos, mask, *, chunk, vh, vw, C, Wp):
    """One tile load per chunk: the ``mask`` level with every agent's
    residual shifts applied to the tile of its chunk's first agent; same
    operands and result shape as :func:`ladder`: :func:`shared_tile_packed`
    on the words of :func:`precompute`.

    Replaces ``scripts/profile_window.py:178`` ``shared_tile``
    (``pallas_call`` at ``:214``).  Bound on the card: bytes, as
    :func:`ladder`.  Design: ``csrc/window_ladder.cu``
    ``window_shared_tile_kernel`` — the blocks are cut at chunk
    boundaries (``ceil(chunk / 32)`` blocks per chunk, each of at most 32
    agents of one chunk), so that a block stages one 16 x 128 tile in
    shared memory and its warps copy every window row from there."""
    return shared_tile_packed(gfull, *precompute(pos, Wp=Wp, C=C), mask,
                              chunk=chunk, vh=vh, vw=vw, C=C)


def shared_tile_packed(gfull, word, aux, mask, *, chunk, vh, vw, C):
    """:func:`shared_tile` on the packed words of :func:`precompute`, as
    :func:`ladder_packed`."""
    _check_geometry("shared_tile", gfull, chunk, vh, vw, C)
    vwc = vw * C
    if _build.route(gfull, word, aux, mask) == "cpu":
        return _shared_tile_plain(gfull, word, aux, mask, chunk=chunk, vh=vh,
                                  vwc=vwc)
    _check("shared_tile", gfull, word, aux, mask, vh, vwc)
    B, Hp, lanes = gfull.shape
    N = word.shape[1]
    out = torch.empty((B, N, vh, vwc), dtype=torch.float32,
                      device=gfull.device)
    if N:
        _build.launch("magent_window_shared_tile", gfull.device,
                      gfull.data_ptr(), word.data_ptr(), aux.data_ptr(),
                      mask.data_ptr(), B, N, chunk, Hp, lanes, vh, vwc,
                      out.data_ptr())
    return out

