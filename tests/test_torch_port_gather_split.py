"""window_gather's launch split, on the CPU: ``gather_split`` (vectors per
block) and ``gather_spans``, the Python twin of the
block spans of ``window_gather_kernel`` in
``magent_tpu_torch/csrc/window_gather.cu``, which cuts the call's flat
``[B, N, vh, vwc]`` output into 16-byte vectors and gives each block a
range of them.

Every span must start 16-byte aligned (the kernel stores whole 16-byte
vectors; only the call's last vector may be partial), the spans must tile
``[0, B*N*vh*vwc)``, and the agents a span touches, with the one after
(a lane reads its next agent's offset), must fit the kernel's table of
``per * kVec // E + 3`` image offsets.  The kernel's addressing —
the window table, a warp tile's lane finding the agent of its first value
with a float multiply by 1/E, corrected to the exact quotient, then its
values 32 apart by a two-agent select (windows wider than a lane's stride
through the tile) or by stepping (narrower ones) — is replayed in numpy,
branch for branch, over those spans and held bit for bit (sign bits
included) against the Pallas kernel in interpret mode.  The CUDA kernel
itself is held against its plain version on the card
(tests/test_torch_port_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu.ops import window_gather as jwg

from magent_tpu_torch.ops import window_gather as twg

from test_torch_port_obs_dtype import _battle_case

H100_SMS = 132
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# window sizes E = vh * vw * C: battle's 13x13x7 (odd) and an even one
WINDOWS = {"odd": 13 * 13 * 7, "even": 13 * 10 * 9}
# agents per env: around the 8-agent multiple and the 32-agent warp
RAGGED_N = (1, 7, 8, 31, 32, 33, 1000)


@pytest.mark.parametrize("N", RAGGED_N)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", WINDOWS)
def test_spans_tile_the_output_aligned(N, dtype, window):
    E = WINDOWS[window]
    out_dtype = DTYPES[dtype]
    kvec = twg.vec_width(out_dtype)
    size = torch.empty((), dtype=out_dtype).element_size()
    assert kvec * size == 16
    for B in (1, 16):
        picked = twg.gather_split(B, N, E, out_dtype, H100_SMS)
        assert picked % twg.GATHER_TILE == 0
        for per in (picked, 32, 96, 1024):
            spans = twg.gather_spans(B, N, E, out_dtype, per)
            total = B * N * E
            assert spans[0][0] == 0 and spans[-1][1] == total
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert all((start * size) % 16 == 0 for start, _ in spans)
            assert all(end - start == per * kvec for start, end in spans[:-1])
            assert 0 < spans[-1][1] - spans[-1][0] <= per * kvec
            # the agents each span touches, and the next, fit the kernel's
            # offset table
            table = per * kvec // E + 3
            assert all((end - 1) // E - start // E + 2 <= table
                       for start, end in spans)
            # a block's values, plus one window, stay exact in f32
            assert per * kvec + E <= 1 << 24


@pytest.mark.parametrize("B,N,dtype,per,spans", [
    (16, 1000, "f32", 1024, 4622), (16, 1000, "bf16", 1024, 2311),
    (1, 1024, "f32", 544, 557), (1, 1024, "bf16", 256, 592),
    (1, 1, "f32", 256, 2)])
def test_gather_split_fills_the_card(B, N, dtype, per, spans):
    """battle 2x1000, B=16: blocks of the most vectors (1024), 17.5 and 35
    per SM; GridWorld's battle map 125 (1024 slots per group, B=1): at
    least 4 blocks per SM; one window: whatever is left."""
    E = WINDOWS["odd"]
    got = twg.gather_split(B, N, E, DTYPES[dtype], H100_SMS)
    assert got == per
    assert len(twg.gather_spans(B, N, E, DTYPES[dtype], per)) == spans


def _f32_quotient(x, inv):
    """The kernels' integer quotient: ``x`` (< 2**24) times the f32
    reciprocal, truncated."""
    return (x.astype(np.float32) * inv).astype(np.int64)


def _kernel_twin(img, pos, mask, *, vh, vw, C, Wp, out_dtype, per):
    """window_gather_kernel in numpy, branch for branch: the window table
    ``off[w] = r * lanes + c`` (r from the f32 quotient, corrected by
    one), each block's table of ``per * kVec // E + 3`` agent offsets (-1
    for a window that leaves the image or an agent past the call), and
    load_tile over warp tiles of 32 vectors: lane l's first value finds its
    agent from the f32 quotient, corrected; its values l + 32k then pick
    between two agents' offsets by select where E > 32 * (kVec - 1)
    (kWide), else step agent by agent.  Value l + 32k of a tile is the
    tile's staging slot k * 32 + l, stored in place."""
    B, Hp, lanes = img.shape
    N = pos.shape[1]
    vwc = vw * C
    E = vh * vwc
    kvec = twg.vec_width(out_dtype)
    tile_len = 32 * kvec
    flat_img = img.reshape(-1)
    flat_mask = mask.reshape(-1)
    e = np.arange(E)
    r = _f32_quotient(e, np.float32(1) / np.float32(vwc))
    c = e - r * vwc
    r, c = np.where(c < 0, r - 1, np.where(c >= vwc, r + 1, r)), \
        np.where(c < 0, c + vwc, np.where(c >= vwc, c - vwc, c))
    off = r * lanes + c
    p = pos.reshape(-1).astype(np.int64)
    yy = p // Wp
    xx = p - yy * Wp
    ok = (p >= 0) & (yy + vh <= Hp) & (xx * C + vwc <= lanes)
    base = np.where(ok, (np.arange(B * N) // N * Hp + yy) * lanes + xx * C, -1)
    total = B * N * E
    inv_e = np.float32(1) / np.float32(E)
    wide = E > 32 * (kvec - 1)
    out = np.empty(total, np.float32)
    for start, end in twg.gather_spans(B, N, E, out_dtype, per):
        a0 = start // E
        w0 = start - a0 * E
        ga = a0 + np.arange(per * kvec // E + 3)
        s_base = np.where(ga < B * N, base[np.minimum(ga, B * N - 1)], -1)
        n_tiles = -(-(end - start) // tile_len)
        x = w0 + (np.arange(n_tiles)[:, None] * tile_len
                  + np.arange(32)[None, :])  # [tile, lane]
        a = _f32_quotient(x, inv_e)
        a += (x - a * E >= E).astype(np.int64) - (x - a * E < 0)
        w = x - a * E
        vals = np.empty((n_tiles, kvec, 32), np.float32)
        if wide:
            base0, base1 = s_base[a], s_base[a + 1]
            for k in range(kvec):
                nxt = w + 32 * k >= E
                tab = w + 32 * k - np.where(nxt, E, 0)
                b = np.where(nxt, base1, base0)
                vals[:, k] = _loaded(flat_img, flat_mask, off, b, tab)
        else:
            b = s_base[a]
            for k in range(kvec):
                if k:
                    w = w + 32
                    while (w >= E).any():  # the next agent's window
                        step = w >= E
                        w = np.where(step, w - E, w)
                        a = np.where(step, a + 1, a)
                        b = np.where(step, s_base[a], b)
                vals[:, k] = _loaded(flat_img, flat_mask, off, b, w)
        out[start:end] = vals.reshape(-1)[:end - start]
    return torch.from_numpy(out).reshape(B, N, vh, vwc).to(out_dtype)


def _loaded(flat_img, flat_mask, off, b, w):
    """A value of load_tile, multiplied at the staging store: img[base +
    off[w]] * mask[w], or +0.0 where the agent's offset is -1."""
    ok = b >= 0
    v = flat_img[np.where(ok, b + off[w], 0)]
    return np.where(ok, v * flat_mask[w], np.float32(0))


@pytest.mark.parametrize("N", [37, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per", [None, 32])
def test_kernel_addressing_matches_jax(N, dtype, per):
    """The replayed addressing on battle's 13x91 windows over a signed
    image (so that masked-off values are -0.0 where the image is
    negative), in the split ``gather_split`` picks and in blocks of one
    warp tile, which end inside windows: equal to the Pallas kernel in
    interpret mode, bits included."""
    img, pos, mask, kw = _battle_case(N + 3, N=N)
    img = img - np.float32(0.5)
    out_dtype = DTYPES[dtype]
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = np.asarray(jwg.window_gather(
        jnp.asarray(img), jnp.asarray(pos) * 1024, jnp.asarray(mask),
        chunk=8, interpret=True, out_dtype=jdtype, **kw))
    E = kw["vh"] * kw["vw"] * kw["C"]
    per = per or twg.gather_split(img.shape[0], N, E, out_dtype, H100_SMS)
    got = _kernel_twin(img, pos, mask, **kw, out_dtype=out_dtype, per=per)
    bits = (torch.int32, np.int32) if dtype == "f32" else (torch.int16,
                                                           np.int16)
    np.testing.assert_array_equal(got.view(bits[0]).numpy(),
                                  want.view(bits[1]))
    assert int((got == 0).logical_and(got.signbit()).sum()) > 0



@pytest.mark.parametrize("N", [37, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per", [None, 32])
def test_kernel_addressing_narrow_matches_jax(N, dtype, per):
    """The same over 3x21 windows (E = 63, narrower than a lane's stride
    through a warp tile in either dtype: the kernel's stepping branch),
    in-map positions, a mask with zeros."""
    vh, vw, C = 3, 3, 7
    Hp, Wp, lanes, pad_y, pad_x = twg.padded_geometry(20, 20, C, vh, vw)
    rng = np.random.RandomState(N)
    B = 2
    img = rng.uniform(-0.5, 0.5, size=(B, Hp, lanes)).astype(np.float32)
    # the top-left cells of in-map agents' windows (view offset -1)
    ys = rng.randint(0, 20, size=(B, N)) + pad_y - 1
    xs = rng.randint(0, 20, size=(B, N)) + pad_x - 1
    pos = (ys * Wp + xs).astype(np.int32)
    mask = (rng.uniform(size=(vh, vw * C)) < 0.7).astype(np.float32)
    kw = dict(vh=vh, vw=vw, C=C, Wp=Wp)
    out_dtype = DTYPES[dtype]
    E = vh * vw * C
    assert E <= 32 * (twg.vec_width(out_dtype) - 1)
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = np.asarray(jwg.window_gather(
        jnp.asarray(img), jnp.asarray(pos) * 1024, jnp.asarray(mask),
        chunk=8, interpret=True, out_dtype=jdtype, **kw))
    per = per or twg.gather_split(B, N, E, out_dtype, H100_SMS)
    got = _kernel_twin(img, pos, mask, **kw, out_dtype=out_dtype, per=per)
    bits = (torch.int32, np.int32) if dtype == "f32" else (torch.int16,
                                                           np.int16)
    np.testing.assert_array_equal(got.view(bits[0]).numpy(),
                                  want.view(bits[1]))
    assert int((got == 0).logical_and(got.signbit()).sum()) > 0
