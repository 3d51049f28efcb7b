"""Cost-ladder profile of the port's window gather at the battle bench
geometry (map 200, C=5, 13x13 windows, B=16 envs of 2048 agents, chunks of
200): the counterpart of ``scripts/profile_window.py``.

Each variant adds one cost component to the port's warp-per-row window
kernel (``ops/window_ladder.py``, ``csrc/window_ladder.cu``):

    floor   the warp-per-row store loop, writing a constant
    smem    + the per-agent word reads into shared memory and the unpack
    load    + the row reads at the replica-offset corner
    roll1   + the residual row offset
    roll2   + the residual lane offset (the true window)
    mask    + the mask multiply (== window_gather4 without an epilogue)
    shared  one tile load per chunk, per-agent residual offsets
    prod    the port's window_gather4, no epilogue
    prod_mm window_gather4 with the minimap, self mark and liveness

On the card each variant's kernel is timed alone (CUDA events around 50
calls queued behind a spin kernel; the ladder and ``shared`` on words
packed once, as the TPU kernels get theirs by scalar prefetch), and the
run asserts that ``window_gather4`` equals its plain version and that
``ladder(mask)`` equals ``window_gather4``, exactly.

Usage:  python -m magent_tpu_torch.tools.profile_window [variant ...]
        python -m magent_tpu_torch.tools.profile_window --cpu [variant ...]
``--cpu`` runs the plain versions at the script's interpret geometry (B=4,
N=64, chunks of 8) and times them on the host's clock.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch

from .. import random as rnd
from ..ops import window_gather as wg
from ..ops import window_ladder as wl
from ..ranges import circle_range
from .timing import device_ms

H = W = 200
C = 5
VH = VW = 13
# (B, N, chunk): bench.py's battle geometry on the card, the script's
# interpret geometry on the CPU
CARD = (16, 2048, 200)
CPU = (4, 64, 8)
VARIANTS = wl.LEVELS + ("shared", "prod", "prod_mm")
# the cost component each ladder level adds to the one before
COMPONENTS = {"floor": "the warp-per-row store loop",
              "smem": "the per-agent word reads and unpack",
              "load": "the row reads at the replica corner",
              "roll1": "the residual row offset",
              "roll2": "the residual lane offset",
              "mask": "the mask multiply"}
REPS = 50
# the inputs' key, the script's PRNGKey(0)
SEED = 0


def make_inputs(seed, *, B, N, device):
    """The padded image (uniform), top-left cells of agents placed
    uniformly on the map, battle's circular 13x13 view mask, and the
    script's epilogue operands (zero minimaps, a mask of ones, every agent
    live), from ``seed`` with the port's ``random`` -> dict."""
    Hp, Wp, lanes, pad_y, pad_x = wg.padded_geometry(H, W, C, VH, VW)
    keys = rnd.split(rnd.PRNGKey(seed, device=device), 3)
    x = rnd.bits(keys[0], (B, N)) % W
    y = rnd.bits(keys[1], (B, N)) % H
    pos = ((y + pad_y - VH // 2) * Wp + x + pad_x - VW // 2).to(torch.int32)
    view = circle_range(VH // 2, 0.0, VW % 2).mask
    mask = torch.from_numpy(np.repeat(view, C, axis=1).astype(np.float32))
    return dict(gfull=rnd.uniform(keys[2], (B, Hp, lanes)), pos=pos,
                mask=mask.to(device),
                mm_img=torch.zeros((B, VH, VW * C), device=device),
                mm_mask=torch.ones((VH, VW * C), device=device),
                act=torch.ones((B, N), dtype=torch.int32, device=device),
                Wp=Wp)


def geometry(inp):
    """The window keywords of the entry points for ``inp``."""
    return dict(vh=VH, vw=VW, C=C, Wp=inp["Wp"])


def variant_calls(inp, chunk):
    """{variant: a call} on ``inp``: the ladder levels and ``shared`` on
    words packed once (as the TPU kernels get theirs by scalar prefetch),
    ``prod`` and ``prod_mm`` on positions packed once; each its kernel on
    the card, its plain version on the CPU."""
    g, pos, mask = inp["gfull"], inp["pos"], inp["mask"]
    geo = geometry(inp)
    packed = pos * 1024
    word, aux = wl.precompute(pos, Wp=inp["Wp"], C=C)
    win = dict(vh=VH, vw=VW, C=C, chunk=chunk)
    calls = {level: functools.partial(wl.ladder_packed, g, word, aux, mask,
                                      level=level, **win)
             for level in wl.LEVELS}
    calls["shared"] = functools.partial(wl.shared_tile_packed, g, word, aux,
                                        mask, **win)
    calls["prod"] = lambda: wg.window_gather4(g, packed, mask, **geo)
    calls["prod_mm"] = lambda: wg.window_gather4(
        g, packed, mask, inp["mm_img"], inp["mm_mask"], inp["act"], **geo)
    return calls


def host_ms(fn, reps: int) -> float:
    """Host time per call of ``fn`` in ms (CPU tensors), after a warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def profile(which, inp, chunk, reps=REPS):
    """{variant: ms per call} of the variants ``which``: device time on the
    card, host time on the CPU."""
    calls = variant_calls(inp, chunk)
    timer = device_ms if inp["gfull"].is_cuda else host_ms
    return {name: timer(calls[name], reps) for name in which}


def increments(ms):
    """{level: (ms over the level before, that level)} of the ladder levels
    in ``ms`` (``floor``'s over "nothing")."""
    out, prev = {}, None
    for level in wl.LEVELS:
        if level in ms:
            out[level] = (ms[level] - (ms[prev] if prev else 0.0),
                          prev or "nothing")
            prev = level
    return out


def check(inp, chunk):
    """Assert that ``window_gather4`` equals ``window_gather_ref`` and that
    ``ladder(mask)`` equals ``window_gather4``, exactly -> both max |diff|."""
    g, pos, mask = inp["gfull"], inp["pos"], inp["mask"]
    geo = geometry(inp)
    prod = wg.window_gather4(g, pos * 1024, mask, **geo)
    ref = wg.window_gather_ref(g, pos, mask, **geo)
    got = wl.ladder(g, pos, mask, level="mask", chunk=chunk, **geo)
    err = float((prod - ref).abs().max())
    lerr = float((got - prod).abs().max())
    if err or lerr:
        raise AssertionError("window_gather4 vs window_gather_ref %g, "
                             "ladder(mask) vs window_gather4 %g" % (err, lerr))
    return err, lerr


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m magent_tpu_torch.tools.profile_window",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", metavar="variant",
                        help="any of %s (default: all)" % " ".join(VARIANTS))
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain versions on the CPU at B=4, "
                             "N=64, chunks of 8")
    args = parser.parse_args(argv)
    bad = sorted(set(args.variants) - set(VARIANTS))
    if bad:
        parser.error("unknown variants %s; choose from %s" % (bad, VARIANTS))
    which = [v for v in VARIANTS if v in args.variants] or list(VARIANTS)
    if args.cpu:
        device, where = torch.device("cpu"), "CPU, host clock"
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
        where = torch.cuda.get_device_name(device) + ", device time"
    else:
        parser.error("no CUDA device; pass --cpu for the plain versions")
    B, N, chunk = CPU if args.cpu else CARD
    inp = make_inputs(SEED, B=B, N=N, device=device)
    ms = profile(which, inp, chunk, reps=1 if args.cpu else REPS)
    for name in which:
        print("%-8s %9.4f ms/call   (%dx%d agents, chunks of %d; %s)"
              % (name, ms[name], B, N, chunk, where), flush=True)
    for level, (step, prev) in increments(ms).items():
        print("%-8s %+9.4f ms over %s: %s" % (level, step, prev,
                                             COMPONENTS[level]))
    err, lerr = check(inp, chunk)
    print("window_gather4 vs window_gather_ref max|diff| = %g" % err)
    print("ladder(mask) vs window_gather4 max|diff| = %g" % lerr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
