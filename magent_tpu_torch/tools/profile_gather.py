"""The window kernel's launch splits on the card (``csrc/window_gather.cu``
``window_gather_kernel``), each entry point and form on the operands of
its path, in every vectors-per-span split:

- ``window_gather``: battle's views at the lockstep path's shapes (2x1000,
  map 200, B=16: image ``[16, 256, 1925]``, 13x91 windows) and one env of
  them (B=1, as the GridWorld's calls are), f32 and bf16;
- ``window_gather4``: one recorded step of pursuit map 64, B=16 ([51, 102],
  placements seed 11), both groups, in its three epilogue forms (none;
  liveness, the path's; a seeded pooled minimap, self cells and liveness),
  f32 and bf16;
- ``window_gather_banded``: one recorded step of pursuit on one world at
  map 500 and at map 1000 (placements seed 5), both groups, in slot order
  with the path's liveness epilogue, with none and with the seeded minimap
  epilogue, and in band order (the kernel alone on the step's band
  table), f32, and at map 1000 bf16 too.

Each form is timed with the split the wrapper picks
(``ops/window_gather.py`` ``gather_split``) and with every other split of
PERS, each held bit for bit against its plain version first.

Usage:  python -m magent_tpu_torch.tools.profile_gather
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
# pursuit's maps: the replica route's (B=16) and the banded route's (one
# world), with the scripts' placement seeds (train_evidence, bench_pursuit)
P_MAP, P_ENVS, P_SEED = 64, 16, 11
P_BANDED = ((500, 5), (1000, 5))


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


def recorded_calls(venv, state, name):
    """The ``(args, kwargs)`` of every call of ``wg.<name>`` in one
    ``observe_all`` of ``venv`` on ``state``."""
    calls = []
    original = getattr(wg, name)

    def rec(*args, **kwargs):
        calls.append(([a.clone() for a in args], dict(kwargs)))
        return original(*args, **kwargs)

    setattr(wg, name, rec)
    try:
        venv.observe_all(state)
    finally:
        setattr(wg, name, original)
    return calls


def battle_operands(device):
    """(image, pos, mask, geometry kwargs) of group 0's window_gather call
    in one observe_all of battle 2x1000, B=16."""
    from .. import random as rnd
    from ..builtin.config import battle
    from ..parallel import VecGridWorld

    venv = VecGridWorld(battle.get_config(200), [1000, 1000], 16,
                        device=device)
    (img, pos, mask), kw = recorded_calls(
        venv, venv.reset(rnd.PRNGKey(1)), "window_gather")[0]
    kw = {n: kw[n] for n in ("vh", "vw", "C", "Wp")}
    return img, pos, mask, kw


def pursuit_calls(map_size, n_envs, seed, name, device):
    """Both groups' calls of ``wg.<name>`` in one observe_all of pursuit
    at ``map_size`` (the scripts' placements from ``seed``) after a reset
    (key 1)."""
    from .. import random as rnd
    from ..builtin.config import pursuit
    from ..parallel import VecGridWorld

    placements, _ = pursuit.layout(map_size, seed)
    venv = VecGridWorld(pursuit.get_config(map_size),
                        [len(p) for p in placements], n_envs,
                        placements=placements, device=device)
    return recorded_calls(venv, venv.reset(rnd.PRNGKey(1)), name)


def minimap_operands(B, N, vh, vw, C, device, seed=0):
    """A seeded pooled minimap [B, vh, vw, C] over two minimap channels,
    the channels [C] and self cells [B, N] int32 (pursuit has no
    minimap; these give the epilogue values that show a wrong add)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    ch = torch.zeros(C)
    ch[[2, C - 1]] = 1.0
    mm = torch.rand((B, vh, vw, C), generator=gen) * ch
    self_cell = torch.randint(0, vh * vw, (B, N), generator=gen,
                              dtype=torch.int32)
    return mm.to(device), ch.to(device), self_cell.to(device)


def gather4_forms(calls):
    """{form: [(args, kwargs)]} of window_gather4 on a step's calls: no
    epilogue, the path's liveness, and minimap + self mark + liveness."""
    forms = {"no epilogue": [], "liveness": [], "minimap": []}
    for (img, pos, mask), kw in calls:
        geo = {n: kw[n] for n in ("vh", "vw", "C", "Wp")}
        forms["no epilogue"].append(((img, pos, mask), geo))
        forms["liveness"].append(((img, pos, mask), dict(geo, act=kw["act"])))
        vh, vw, C = geo["vh"], geo["vw"], geo["C"]
        mm, ch, self_cell = minimap_operands(*pos.shape, vh, vw, C,
                                             pos.device)
        forms["minimap"].append(((img, pos + self_cell, mask), dict(
            geo, act=kw["act"], mm_img=mm.reshape(img.shape[0], vh, vw * C),
            mm_mask=ch.repeat(vh, vw))))
    return forms


def banded_forms(calls):
    """{form: [(args, kwargs)]} of window_gather_banded on a step's calls
    (slot order, the path's liveness epilogue): slot order with liveness,
    with no epilogue and with minimap + self mark + liveness, and band
    order (``unsort=False``)."""
    forms = {"liveness": [], "no epilogue": [], "minimap": [],
             "band order": []}
    for (img, pos, mask), kw in calls:
        forms["liveness"].append(((img, pos, mask), kw))
        plain = {n: v for n, v in kw.items() if n != "act"}
        forms["no epilogue"].append(((img, pos, mask), plain))
        mm, ch, self_cell = minimap_operands(*pos.shape, kw["vh"], kw["vw"],
                                             kw["C"], pos.device)
        forms["minimap"].append(((img, pos, mask), dict(
            kw, mm=mm, mm_maskc=ch, self_cell=self_cell)))
        forms["band order"].append(((img, pos, mask),
                                    dict(plain, unsort=False)))
    return forms


def kernel_launch(name, args, kwargs):
    """(``launch(per) -> windows``, the launch's B, N) of one call of the
    window kernel as entry point ``name`` launches it, without its
    host-side tables (the band-order form: over its band table)."""
    img, pos, mask = args
    geo = {n: kwargs[n] for n in ("vh", "vw", "C", "Wp")}
    geo["out_dtype"] = kwargs.get("out_dtype", torch.float32)
    if name == "window_gather":
        return (lambda per: wg._gather_launch(img, pos, mask, **geo, per=per),
                pos.shape)
    if name == "window_gather4":
        return (lambda per: wg._gather4_launch(
            img, pos, mask, kwargs.get("mm_img"), kwargs.get("mm_mask"),
            kwargs.get("act"), **geo, per=per), pos.shape)
    epi = {n: kwargs[n] for n in ("act", "mm", "self_cell", "mm_maskc")
           if kwargs.get(n) is not None}
    if not kwargs.get("unsort", True):
        n_bands, _ = wg._band_geometry(img.shape[1], geo["vh"],
                                       kwargs["band_rows"])
        pos = wg.banded_tables(pos, Wp=geo["Wp"],
                               band_rows=kwargs["band_rows"],
                               n_bands=n_bands, chunk=kwargs["chunk"])[0]
    return (lambda per: wg._banded_launch(img, pos, mask, **geo, **epi,
                                          per=per), pos.shape)


def split_table(name, args, kwargs, splits, reps=50):
    """Device ms per launch of each split (vectors per span) of one call,
    each equal to the plain version bit for bit first -> {per: ms}."""
    plain = {"window_gather": wg.window_gather_ref,
             "window_gather4": wg.window_gather4_ref,
             "window_gather_banded": wg.window_gather_banded_ref}[name]
    want = plain(*args, **kwargs)
    want = want[0] if isinstance(want, tuple) else want
    bits = torch.int32 if want.dtype == torch.float32 else torch.int16
    launch, _ = kernel_launch(name, args, kwargs)
    out = {}
    for per in splits:
        got = launch(per)
        if not torch.equal(got.view(bits), want.view(bits)):
            raise AssertionError("%s split %d (%s) differs from the plain "
                                 "version" % (name, per, want.dtype))
        out[per] = device_ms(lambda p=per: launch(p), reps)
    return out


def report(name, label, calls, n_sms):
    """Time each call of one form in every split and print one line per
    call: bound, the pick, the best split and the whole table."""
    for i, (args, kwargs) in enumerate(calls):
        out_dtype = kwargs.get("out_dtype", torch.float32)
        _, (B, N) = kernel_launch(name, args, kwargs)
        E = kwargs["vh"] * kwargs["vw"] * kwargs["C"]
        picked = wg.gather_split(B, N, E, out_dtype, n_sms)
        splits = [picked] + [p for p in PERS if p != picked]
        ms = split_table(name, args, kwargs, splits)
        out = [torch.empty((B, N, kwargs["vh"], kwargs["vw"] * kwargs["C"]),
                           dtype=out_dtype, device=args[0].device)]
        bound = window_bytes(name, args, kwargs, out) / HBM_BYTES_PER_S * 1e3
        best = min(ms, key=ms.get)
        print("%s %s, %s, call %d, B=%d, N=%d, image %s: bound %.6f ms "
              "(bytes); picked %d (%d spans): %.4f ms, share %.3f; best %d: "
              "%.4f ms; all (vectors per span:ms) %s" % (
                  name, str(out_dtype).removeprefix("torch."), label, i, B,
                  N, tuple(args[0].shape), bound, picked,
                  len(wg.gather_spans(B, N, E, out_dtype, picked)),
                  ms[picked], bound / ms[picked], best, ms[best],
                  " ".join("%d:%.4f" % (p, t) for p, t in ms.items())),
              flush=True)


def as_dtype(calls, out_dtype):
    return [(a, dict(k, out_dtype=out_dtype)) for a, k in calls]


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
    for B in (16, 1):
        call = ((img[:B].contiguous(), pos[:B].contiguous(), mask), kw)
        for out_dtype in wg.OUT_DTYPES:
            report("window_gather", "battle 2x1000", as_dtype([call],
                                                              out_dtype),
                   n_sms)
    del img, pos, mask
    g4 = gather4_forms(pursuit_calls(P_MAP, P_ENVS, P_SEED, "window_gather4",
                                     device))
    for form, calls in g4.items():
        for out_dtype in wg.OUT_DTYPES:
            report("window_gather4", "pursuit map %d, %s" % (P_MAP, form),
                   as_dtype(calls, out_dtype), n_sms)
    del g4
    for map_size, seed in P_BANDED:
        forms = banded_forms(pursuit_calls(map_size, 1, seed,
                                           "window_gather_banded", device))
        dtypes = wg.OUT_DTYPES if map_size == 1000 else (torch.float32,)
        for form, calls in forms.items():
            for out_dtype in dtypes:
                report("window_gather_banded", "pursuit map %d, %s" % (
                    map_size, form), as_dtype(calls, out_dtype), n_sms)
        del forms
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
