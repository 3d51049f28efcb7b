"""Cost ladder of the banded window gather (``ops.window_gather_banded``,
PERF.md §6 row 13; port of ``scripts/profile_banded.py``): the observation
path of worlds whose channel image is past the window kernel's image
budget (single-world 1e5/1e6 agents, 16 x 62,500 agents at map 1118).

The JAX call has four parts: PACK (the overlapping-band image copy), SORT
(band sort and chunk-padding tables), KERNEL and UNSORT (the gather back
to slot order).  The port's path is one launch: its slot-order kernel reads
the image in place and writes each window straight to its slot, so PACK
and UNSORT do not exist, and their variants (``pack``, ``unsort``,
``unsort_flat``, ``unsort_lane``, ``unsort_scatter``, ``unsort_bf16``)
print that they are fused; SORT exists in the band-order form
(``unsort=False``: ``banded_tables``, then the same kernel over the band
table).  Each variant is timed with CUDA events over ``--steps``
iterations per call, a warm-up call and ``--calls`` timed calls, and each
iteration's input depends on the iteration's key (``k = fold_in(k, t)``),
so that no call repeats the previous one's work.  ``fixed_pos`` keeps the
positions and ``fixed_img`` the image from one iteration to the next, as
the JAX variants do to hoist SORT or PACK out of its loop.  ``plain``,
run only when named (the JAX script's opt-in ``xla``), is the gather's
plain PyTorch version (``window_gather_ref``) on ``fixed_img``'s moved
positions.  At 16 x 62,500 it holds about 17.5 GB of the card at its
peak, beside its 0.45 GB image: PyTorch's advanced indexing broadcasts
the env, row and lane indices to the windows' shape, 16 x 62,500 x 11 x
55, as three int64 tensors of 4.84 GB, beside the 2.42 GB of f32 windows
(17.489 GB measured on an H100 by ``chip_smoke.py`` phase 16).

    python -m magent_tpu_torch.tools.profile_banded --n_envs 16
        --per_env 62500 [variants ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from .. import random as rnd
from ..ops import window_gather as wg
from ..parallel import resolve_device
from .timing import elapsed_ms

VARIANTS = ("full", "fixed_pos", "fixed_img", "kernel", "pack", "sort",
            "unsort", "unsort_flat", "unsort_lane", "unsort_scatter",
            "unsort_bf16", "plain")
DEFAULTS = ("full", "fixed_pos", "fixed_img", "pack", "sort", "unsort",
            "unsort_flat", "unsort_lane", "unsort_scatter", "unsort_bf16")
FUSED = {"pack": "the kernel reads the image in place: no band slab copy",
         "unsort": "the slot-order kernel writes each window to its slot"}


def cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--per_env", type=int, default=62500)
    ap.add_argument("--vh", type=int, default=11)  # forest predator view
    ap.add_argument("--C", type=int, default=5)    # wall + 2 groups x (has,hp)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--band_rows", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=40)
    ap.add_argument("variants", nargs="*", default=list(DEFAULTS),
                    help="of %s (default: all but plain, which holds "
                    "about 17.5 GB of the card at 16 x 62,500)"
                    % " ".join(VARIANTS))
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    return ap


def build(args, device):
    """The image, positions and mask at ``args``' geometry on ``device`` ->
    ({variant: body}, the key), each body one iteration ``body(k)`` -> its
    sink."""
    B, N = args.n_envs, args.per_env
    vh = vw = args.vh
    C = args.C
    map_size = int(math.sqrt(N * 20))
    Hp, Wp, lanes, pad_y, pad_x = wg.padded_geometry(map_size, map_size, C,
                                                     vh, vw)
    n_bands = -(-Hp // args.band_rows)
    img_mb = B * Hp * lanes * 4 / 1e6
    print("map %d^2, %d envs x %d agents; image [B,%d,%d] = %.0f MB, %d "
          "bands" % (map_size, B, N, Hp, lanes, img_mb, n_bands), flush=True)

    key = rnd.PRNGKey(0, device)
    img = rnd.uniform(key, (B, Hp, lanes))

    def rand_pos(k):  # top-left cells of in-map agents
        y = rnd.randint(k, (B, N), pad_y, pad_y + map_size - vh)
        x = rnd.randint(rnd.fold_in(k, 1), (B, N), pad_x,
                        pad_x + map_size - vw)
        return (y * Wp + x).to(torch.int32)

    pos0 = rand_pos(rnd.fold_in(key, 7))
    mask = torch.ones((vh, vw * C), device=device)
    kw = dict(vh=vh, vw=vw, C=C, Wp=Wp, chunk=args.chunk,
              band_rows=args.band_rows)

    def moved(k, pos):
        return (pos + rnd.randint(k, (B, N), 0, 2)).clamp(
            0, Hp * Wp - 1).to(torch.int32)

    def lit(k, img):
        return img + rnd.uniform(k, (1, 1, 1))

    def sink_windows(out):
        return out[:, :, 0, 0].float().sum()

    def full(k):
        return sink_windows(wg.window_gather_banded(
            lit(k, img), moved(k, pos0), mask, **kw))

    def fixed_pos(k):
        return sink_windows(wg.window_gather_banded(lit(k, img), pos0, mask,
                                                    **kw))

    def fixed_img(k):
        return sink_windows(wg.window_gather_banded(img, moved(k, pos0),
                                                    mask, **kw))

    def kernel(k):
        out, inv = wg.window_gather_banded(lit(k, img), pos0, mask,
                                           unsort=False, **kw)
        return out[:, :, 0, 0].sum()

    def sort(k):
        pos_pad, chunk_band, inv = wg.banded_tables(
            moved(k, pos0), Wp=Wp, band_rows=args.band_rows,
            n_bands=n_bands, chunk=args.chunk)
        return (pos_pad[:, ::64].sum() + inv[:, ::64].sum()
                + chunk_band[:, ::8].sum())

    def plain(k):
        return sink_windows(wg.window_gather_ref(img, moved(k, pos0), mask,
                                                 vh=vh, vw=vw, C=C, Wp=Wp))

    return dict(full=full, fixed_pos=fixed_pos, fixed_img=fixed_img,
                kernel=kernel, sort=sort, plain=plain), key


def main(argv=None):
    """-> {variant: (ms per step, the warm-up call's sink)}; a fused
    variant maps to None."""
    ap = cli()
    args = ap.parse_args(argv)
    if set(args.variants) - set(VARIANTS):
        ap.error("variants are %s" % " ".join(VARIANTS))
    device = resolve_device(args.device)
    bodies, key = build(args, device)
    agents = args.n_envs * args.per_env

    @torch.no_grad()
    def run(k, body):
        sinks = []
        for t in range(args.steps):
            k = rnd.fold_in(k, t)
            sinks.append(body(k))
        return torch.stack(sinks).sum()

    results = {}
    for name in args.variants:
        fused = FUSED.get(name.split("_")[0])
        if fused:
            print("%-12s fused: %s" % (name, fused), flush=True)
            results[name] = None
            continue
        body = bodies[name]
        print("[%s] running %s..." % (time.strftime("%H:%M:%S"), name),
              flush=True)
        warm = float(run(key, body))
        calls = iter(range(args.calls))
        ms = elapsed_ms(lambda: run(rnd.fold_in(key, next(calls)), body),
                        args.calls, device) / (args.steps * args.calls)
        rate = agents * 1e3 / ms
        print("%-12s %9.3f ms/step   %7.2fM windows/s"
              % (name, ms, rate / 1e6), flush=True)
        results[name] = (ms, warm)
    return results


if __name__ == "__main__":
    main()
