"""window_gather's launch splits on the card (``csrc/window_gather.cu``
``window_gather_kernel``): battle's views at the lockstep path's shapes
(2x1000, map 200, B=16: image ``[16, 256, 1925]``, 13x91 windows) and one
env of them (B=1, as the GridWorld's calls are), in f32 and bf16, each
timed with the split the wrapper picks (``ops/window_gather.py``
``gather_split``) and with every other vectors-per-span split, each held
bit for bit against its plain version first.

Usage:  python -m magent_tpu_torch.tools.profile_gather
The operands are group 0's call of one recorded ``observe_all`` of
``VecGridWorld(battle(200), [1000, 1000], 16)`` after a reset (key 1).
Times are device time per launch (CUDA events around 50 calls queued
behind a spin kernel, median of 3); the bound is bytes
(:func:`window_bytes`) over HBM_BYTES_PER_S.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import window_gather as wg
from .timing import HBM_BYTES_PER_S, device_ms

# vectors per span, beside the pick
PERS = (256, 512, 1024, 2048, 4096, 8192)


def window_bytes(name, args, kwargs, out) -> int:
    """Bytes a window gather must move: every output written once, pos,
    mask and the epilogue operands read once, and each image element that
    some window reads under a non-zero mask entry read once.  The rest of
    the padded image (alignment slack, unused padding, cells no agent sees)
    is never needed."""
    gfull, pos, mask = args
    C, Wp = kwargs["C"], kwargs["Wp"]
    tl = pos.long() >> 10 if name.startswith("window_gather4") else \
        pos.long()
    oy, ox = torch.nonzero(mask != 0, as_tuple=True)
    touched = torch.zeros(gfull.shape[1:], dtype=torch.bool,
                          device=gfull.device)
    n_read = 0
    for b in range(gfull.shape[0]):
        touched.zero_()
        touched[(tl[b] // Wp)[:, None] + oy,
                (tl[b] % Wp)[:, None] * C + ox] = True
        n_read += int(touched.sum())
    epilogue = [v for v in kwargs.values() if isinstance(v, torch.Tensor)]
    return (n_read * gfull.element_size()
            + sum(t.numel() * t.element_size()
                  for t in [pos, mask, *epilogue, *out]))


def battle_operands(device):
    """(image, pos, mask, geometry kwargs) of group 0's window_gather call
    in one observe_all of battle 2x1000, B=16."""
    from .. import random as rnd
    from ..builtin.config import battle
    from ..parallel import VecGridWorld

    venv = VecGridWorld(battle.get_config(200), [1000, 1000], 16,
                        device=device)
    state = venv.reset(rnd.PRNGKey(1))
    calls = []
    original = wg.window_gather

    def rec(*args, **kwargs):
        calls.append(([a.clone() for a in args], dict(kwargs)))
        return original(*args, **kwargs)

    wg.window_gather = rec
    try:
        venv.observe_all(state)
    finally:
        wg.window_gather = original
    (img, pos, mask), kw = calls[0]
    kw = {n: kw[n] for n in ("vh", "vw", "C", "Wp")}
    return img, pos, mask, kw


def split_table(img, pos, mask, kw, out_dtype, splits, reps=50):
    """Device ms per launch of each split (vectors per span) on these CUDA
    operands, each equal to the plain version bit for bit first ->
    {per: ms}."""
    want = wg.window_gather_ref(img, pos, mask, **kw, out_dtype=out_dtype)
    bits = torch.int32 if out_dtype == torch.float32 else torch.int16
    out = {}
    for per in splits:
        got = wg._gather_launch(img, pos, mask, **kw, out_dtype=out_dtype,
                                per=per)
        if not torch.equal(got.view(bits), want.view(bits)):
            raise AssertionError("window_gather split %d (%s) differs from "
                                 "the plain version" % (per, out_dtype))
        out[per] = device_ms(lambda p=per: wg._gather_launch(
            img, pos, mask, **kw, out_dtype=out_dtype, per=p), reps)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m magent_tpu_torch.tools.profile_gather",
        description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    if not torch.cuda.is_available():
        parser.error("no CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    print("%s, %d SMs" % (torch.cuda.get_device_name(device), n_sms))
    img, pos, mask, kw = battle_operands(device)
    E = kw["vh"] * kw["vw"] * kw["C"]
    for B in (16, 1):
        args = (img[:B].contiguous(), pos[:B].contiguous(), mask)
        N = pos.shape[1]
        for out_dtype in wg.OUT_DTYPES:
            picked = wg.gather_split(B, N, E, out_dtype, n_sms)
            splits = [picked] + [p for p in PERS if p != picked]
            ms = split_table(*args, kw, out_dtype, splits)
            out = [torch.empty((B, N, kw["vh"], kw["vw"] * kw["C"]),
                               dtype=out_dtype, device=device)]
            bound = window_bytes("window_gather", args, kw, out) / \
                HBM_BYTES_PER_S * 1e3
            best = min(ms, key=ms.get)
            print("window_gather %s, B=%d, N=%d, image %s: bound %.6f ms "
                  "(bytes); picked %d (%d spans): %.4f ms, share %.3f; best "
                  "%d: %.4f ms; all (vectors per span:ms) %s"
                  % (
                      str(out_dtype).removeprefix("torch."), B, N,
                      tuple(args[0].shape), bound, picked,
                      len(wg.gather_spans(B, N, E, out_dtype, picked)),
                      ms[picked], bound / ms[picked], best, ms[best],
                      " ".join("%d:%.4f" % (p, t) for p, t in ms.items())),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
