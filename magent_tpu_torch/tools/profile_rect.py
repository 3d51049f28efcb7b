"""The split template's launch splits on the card: ``occupant_rect``,
``rect_first_overlap`` and ``rank_prefix`` (``csrc/pair_kernels.cu``) at
the shapes of pursuit's gridless rect path, ``rank_prefix`` also at
battle's lockstep shapes (B=16, A=2000) and in its hp form at the
GridWorld's (B=1, A=2048), ``occupant`` at battle's and ``move_claims``
at the GridWorld's, each form timed with the split the wrapper
picks (``ops/attack_prefix.py`` ``rect_split``) and with every other
(cluster, warps) split, each held exactly against its plain version; the
segmented sweeps ``occupant_rect_seg`` and ``rank_prefix_seg`` on the same
template at pursuit's one world of map 1000 (A = 37,500), with the step's
plan passed in, against the split ``seg_split`` picks and every other.

Also the seeded operands that the card's checks share (``chip_smoke.py``
phases 2 and 4-6, ``tests/test_torch_port_gpu.py``): random bodies at
ragged sizes (:func:`ragged_operands`), two adversarial cases
(:func:`adversarial_operands`), rank_prefix's operands
(:func:`rank_operands`), the occupant's (:func:`cell_operands`) and
move_claims' (:func:`claim_operands`).

Usage:  python -m magent_tpu_torch.tools.profile_rect [--maps 64 500]
        [--seg-maps 1000]
First prints the instruction mix per pair of each kernel's unrolled inner
loop (4 bodies x 4 queries), read with ``cuobjdump -sass`` from the built
library.  The operands are one recorded step of ``VecGridWorld(pursuit(
map))`` with the scripts' placements: map 64 at B=16 (seed 11), larger
maps one world (seed 5); battle's and the GridWorld's rank_prefix forms
take :func:`rank_operands` with battle's damage 2.0, the occupant
:func:`cell_operands` (unique cells), move_claims :func:`claim_operands`
(a third of the slots at the map-125 sentinel); the segmented forms
take the step's operands with values that show a wrong row
(:func:`seg_calls`).  Times are device time per launch (CUDA events
around 50 calls queued behind a spin kernel, median of 3).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import attack_prefix as ap
from .timing import device_ms

# ragged slot counts: around the 128-slot query tile, pursuit's map-64
# capacity (153), its map-500 world (9375) and the single-world pair
# sweeps' largest (QUAD_MAX_SINGLE)
RAGGED_A = (1, 2, 127, 128, 129, 153, 1000, 9375, 16384)
# body sizes by max_body: 2 is pursuit's (2x2 predators, 1x1 prey)
SIZES = {2: ((2, 2), (1, 1)), 3: ((2, 2), (1, 3), (1, 1))}
SPLITS = [(c, w) for c in (1, 2, 4, 8) for w in (1, 2, 4, 8)]
# the segmented sweeps on the split template
SEG_SPLIT_SWEEPS = ("occupant_rect_seg", "rank_prefix_seg")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=a.dtype))


def ragged_operands(A, B, seed, max_body=2):
    """Seeded operands of both sweeps over ``B`` envs of ``A`` slots ->
    (occupant_rect args, rect_first_overlap exclude_self args,
    rect_first_overlap lower_only args), CPU tensors.  Bodies are disjoint:
    one per site of a shuffled lattice of pitch ``max_body + 1`` (a third
    of the sites empty), sizes from ``SIZES``, a sixth dead (empty rect at
    its coordinates).  Query cells: uniform over the map, a quarter inside
    their own body, a fifth ``RECT_PAD``; hp uniform in [0.1, 1).  Query
    rects: each body moved by [-2, 2]^2 (blocking against the bodies;
    claims against one another), a fifth non-queries (``RECT_PAD``, empty
    rect)."""
    rng = np.random.RandomState(seed)
    pitch = max_body + 1
    side = int(np.ceil(np.sqrt(1.5 * A)))
    sites = np.stack([rng.permutation(side * side)[:A] for _ in range(B)])
    x = ((sites % side) * pitch + 1).astype(np.int32)
    y = ((sites // side) * pitch + 1).astype(np.int32)
    sizes = np.array(SIZES[max_body], np.int32)
    pick = rng.randint(len(sizes), size=(B, A))
    dead = rng.uniform(size=(B, A)) < 1 / 6
    bw = np.where(dead, 0, sizes[pick, 0]).astype(np.int32)
    bh = np.where(dead, 0, sizes[pick, 1]).astype(np.int32)
    S = side * pitch + 2
    qx = rng.randint(0, S, size=(B, A))
    qy = rng.randint(0, S, size=(B, A))
    own = rng.uniform(size=(B, A)) < 0.25
    qx = np.where(own, x + rng.randint(0, 2, (B, A)) * (bw > 1), qx)
    qy = np.where(own, y, qy)
    pad = rng.uniform(size=(B, A)) < 0.2
    qx = np.where(pad, ap.RECT_PAD, qx).astype(np.int32)
    qy = np.where(pad, ap.RECT_PAD, qy).astype(np.int32)
    hp = rng.uniform(0.1, 1.0, size=(B, A)).astype(np.float32)
    q = rng.uniform(size=(B, A)) < 0.8
    rx = np.where(q, x + rng.randint(-2, 3, (B, A)), ap.RECT_PAD)
    ry = np.where(q, y + rng.randint(-2, 3, (B, A)), ap.RECT_PAD)
    tbw = np.where(q, np.maximum(sizes[pick, 0], 1), 0)
    tbh = np.where(q, np.maximum(sizes[pick, 1], 1), 0)
    rects = [a.astype(np.int32) for a in (rx, ry, tbw, tbh)]
    occ = [_t(a) for a in (qx, qy, x, y, bw, bh, hp)]
    return (occ, [_t(a) for a in rects + [x, y, bw, bh]],
            [_t(a) for a in rects * 2])


def rank_operands(A, B, seed, integer):
    """Seeded rank_prefix operands over ``B`` envs of ``A`` slots -> (tgt,
    rank, dmg, hp), CPU tensors: a third of the slots non-attackers (the
    sentinel tgt = A, damage 0, as the engine gives them), the others'
    targets drawn from a tenth of the slots so that attackers share them;
    ranks from random bits (``pack_rank``); damages 2.0 (``integer``,
    battle's) or uniform in [0, 1); hp uniform in [0.1, 10)."""
    rng = np.random.RandomState(seed)
    tgt = rng.randint(0, max(1, A // 10), size=(B, A))
    tgt = np.where(rng.uniform(size=(B, A)) < 1 / 3, A, tgt).astype(np.int32)
    bits = rng.randint(0, 2**32, size=(B, A), dtype=np.uint64).astype(
        np.int64)
    dmg = np.full((B, A), 2.0) if integer else rng.uniform(size=(B, A))
    dmg = np.where(tgt == A, 0.0, dmg).astype(np.float32)
    hp = rng.uniform(0.1, 10.0, size=(B, A)).astype(np.float32)
    return (_t(tgt), ap.pack_rank(_t(bits), A), _t(dmg), _t(hp))


def cell_operands(A, B, seed, duplicates=False):
    """Seeded occupant operands over ``B`` envs of ``A`` slots -> (acell,
    cell, hp), CPU tensors.  Unique cells: each env's cells a sample of
    [0, 3A) without repeats, a tenth dead (``CELL_DEAD``, shared by the
    dead, never queried); ``duplicates``: cells drawn from [0, A // 2 + 1)
    with repeats, so piles of two and more slots share a cell.  Half the
    queries aim at a random slot's cell (a dead slot's aims at random),
    the rest uniform over [0, 3A), a fifth ``QUERY_NONE``; hp uniform in
    [0.1, 1)."""
    rng = np.random.RandomState(seed)
    if duplicates:
        cell = rng.randint(0, A // 2 + 1, size=(B, A))
    else:
        cell = np.stack([rng.permutation(3 * A)[:A] for _ in range(B)])
        cell = np.where(rng.uniform(size=(B, A)) < 0.1, ap.CELL_DEAD, cell)
    aim = np.take_along_axis(cell, rng.randint(0, A, size=(B, A)), 1)
    acell = np.where(rng.uniform(size=(B, A)) < 0.5, aim,
                     rng.randint(0, 3 * A, size=(B, A)))
    acell = np.where(acell == ap.CELL_DEAD, rng.randint(0, 3 * A, (B, A)),
                     acell)
    acell = np.where(rng.uniform(size=(B, A)) < 0.2, ap.QUERY_NONE, acell)
    hp = rng.uniform(0.1, 1.0, size=(B, A)).astype(np.float32)
    return _t(acell.astype(np.int32)), _t(cell.astype(np.int32)), _t(hp)


def claim_operands(A, B, seed, sentinel):
    """Seeded move_claims operands over ``B`` envs of ``A`` slots ->
    tcell [B, A] int32, a CPU tensor: a third of the slots non-movers at
    the one shared ``sentinel`` cell (the grid path's H * W), the movers'
    targets drawn from A // 2 + 1 cells, so that they contend."""
    rng = np.random.RandomState(seed)
    tcell = rng.randint(0, A // 2 + 1, size=(B, A))
    tcell = np.where(rng.uniform(size=(B, A)) < 1 / 3, sentinel, tcell)
    return _t(tcell.astype(np.int32))


def occupant_matches(acell, cell):
    """[B, A] int: the slots whose cell equals each query's (the occupant's
    hp sum is exact in any order wherever this is at most two)."""
    return (cell[..., :, None] == acell[..., None, :]).sum(-2)


def adversarial_operands(A, B, case, lower_only=False):
    """Two adversarial inputs -> (occupant_rect args, rect_first_overlap
    args), CPU tensors.  ``"ties"``: every query identical — one query
    cell, inside one of the disjoint lattice bodies, and one 2x2 query rect
    over a pile of bodies at random offsets in [0, 3)^2 (they overlap one
    another), so keys tie and the slot decides.  ``"last"``: the one
    non-empty body at the last slot of the last range of the last tile (A -
    1, or A - 2 under ``lower_only``, whose last pair is (A - 2, A - 1)),
    every query cell and rect on it."""
    qx, qy, x, y, bw, bh, hp = ragged_operands(A, B, 3 * A + 1)[0]
    if case == "ties":
        i = A // 2
        qx = x[:, i:i + 1].expand(B, A).contiguous()
        qy = y[:, i:i + 1].expand(B, A).contiguous()
        rng = np.random.RandomState(A)
        px = _t(rng.randint(0, 3, (B, A)).astype(np.int32))
        py = _t(rng.randint(0, 3, (B, A)).astype(np.int32))
        pw = _t(rng.randint(1, 3, (B, A)).astype(np.int32))
        ph = _t(rng.randint(1, 3, (B, A)).astype(np.int32))
        one = torch.ones((B, A), dtype=torch.int32)
        rect = [one, one, 2 * one, 2 * one]
        bodies = [px, py, pw, ph]
    elif case == "last":
        last = A - 2 if lower_only else A - 1
        if last < 0:
            raise ValueError("no pair reaches the last slot at A=%d" % A)
        bw = torch.zeros_like(bw)
        bh = torch.zeros_like(bh)
        bw[:, last] = 2
        bh[:, last] = 2
        qx = x[:, last:last + 1].expand(B, A).contiguous()
        qy = (y[:, last:last + 1] + 1).expand(B, A).contiguous()
        rect = [qx - 1, qy - 1, 2 * torch.ones_like(qx),
                2 * torch.ones_like(qx)]
        bodies = [x, y, bw, bh]
    else:
        raise ValueError("case must be 'ties' or 'last', got %r" % case)
    return [qx, qy, x, y, bw, bh, hp], rect + (rect if lower_only
                                               else bodies)


def seg_launch(name, args, kwargs, split):
    """One launch of segmented sweep ``name`` (``SEG_SPLIT_SWEEPS``) on CUDA
    operands with ``split``, on the plan its call runs on: ``kwargs``'
    ``plan``, else one made from its ``margin`` and ``seg_win``."""
    if name == "occupant_rect_seg":
        ints, hp, sort_y = list(args[:6]) + [args[8]], args[6], args[7]
    else:
        ints, hp, sort_y = list(args[:2]), args[2], args[3]
    _, _, P, start, overflow = ap._seg_launch_operands(
        name, ints, (hp,), sort_y, kwargs["margin"], kwargs.get("seg_win"),
        kwargs.get("plan"))
    if name == "occupant_rect_seg":
        return ap._occupant_rect_seg_launch(ints, hp, P, start, overflow,
                                            split)
    return ap._rank_prefix_seg_launch(*ints, hp, P, start, overflow, split)


def launch(name, args, kwargs, split):
    """One launch of kernel ``name`` on CUDA operands with ``split``."""
    if name in SEG_SPLIT_SWEEPS:
        return seg_launch(name, args, kwargs, split)
    if name == "occupant":
        return ap._occupant_launch(*args, split)
    if name == "move_claims":
        return ap._move_claims_launch(*args, split)
    if name == "rank_prefix":
        return ap._rank_prefix_launch(*args[:3], args[3] if len(args) > 3
                                      else None, split)
    if name == "occupant_rect":
        return ap._occupant_rect_launch(args[:6], args[6],
                                        kwargs["exclude_self"], split)
    A = args[0].shape[-1]
    stride = ap._rect_stride(A, kwargs["max_body"], kwargs["gate"])
    return ap._rect_first_overlap_launch(args, kwargs["max_body"],
                                         kwargs["gate"], stride, split)


def form_name(name, kwargs):
    if name in SEG_SPLIT_SWEEPS:
        return "%s, window %d" % (name, kwargs["plan"][1])
    if name == "rank_prefix":
        return "rank_prefix%s" % (", hp" if kwargs.get("hp") else "")
    if name in ("occupant", "move_claims"):
        return name
    if name == "occupant_rect":
        return "occupant_rect%s" % (", exclude_self" if kwargs["exclude_self"]
                                    else "")
    return "rect_first_overlap, %s" % kwargs["gate"]


def split_table(name, args, kwargs, splits=SPLITS, reps=50):
    """Device ms per launch of each ``(cluster, warps)`` split in
    ``splits`` on these CUDA operands, each held exactly against the plain
    version first -> {split: ms}."""
    plain = {"occupant": ap.occupant_ref,
             "move_claims": ap.move_claims_ref,
             "occupant_rect": ap.occupant_rect_ref,
             "rect_first_overlap": ap.rect_first_overlap_ref,
             "rank_prefix": ap.rank_prefix_ref,
             "occupant_rect_seg": ap.occupant_rect_seg_ref,
             "rank_prefix_seg": ap.rank_prefix_seg_ref}[name]
    want = plain(*args) if name == "rank_prefix" else plain(*args, **kwargs)
    want = want if isinstance(want, tuple) else (want,)
    out = {}
    for split in splits:
        got = launch(name, args, kwargs, split)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError("%s split %s differs from the plain "
                                     "version" % (form_name(name, kwargs),
                                                  split))
        out[split] = device_ms(lambda s=split: launch(name, args, kwargs, s),
                               reps)
    return out


def pursuit_calls(map_size, device):
    """(name, args, kwargs) of every split-template call of one pursuit
    step (occupant_rect, rect_first_overlap twice, rank_prefix), plus
    occupant_rect with exclude_self on the same operands."""
    from .. import random as rnd
    from ..builtin.config import pursuit
    from ..parallel import VecGridWorld

    n_envs, seed = (16, 11) if map_size == 64 else (1, 5)
    placements, _ = pursuit.layout(map_size, seed)
    venv = VecGridWorld(pursuit.get_config(map_size),
                        [len(p) for p in placements], n_envs,
                        placements=placements, device=device)
    calls = []
    originals = {n: getattr(ap, n) for n in ("occupant_rect",
                                             "rect_first_overlap",
                                             "rank_prefix")}

    def recorder(name):
        def rec(*args, **kwargs):
            kw = dict(exclude_self=False) if name == "occupant_rect" else {}
            calls.append((name, [a.clone() for a in args], dict(kw, **kwargs)))
            return originals[name](*args, **kwargs)
        return rec

    for name in originals:
        setattr(ap, name, recorder(name))
    try:
        state = venv.reset(rnd.PRNGKey(2))
        venv.observe_all(state)
        venv.transition(state, venv.random_actions(rnd.PRNGKey(3)))
    finally:
        for name, fn in originals.items():
            setattr(ap, name, fn)
    occ = [c for c in calls if c[0] == "occupant_rect"][0]
    calls.append((occ[0], occ[1], dict(occ[2], exclude_self=True)))
    return calls


def seg_calls(map_size, device):
    """(name, args, kwargs) of the segmented sweeps on the split template
    from one step of pursuit's one world at ``map_size`` (seed 5), with
    the step's plan in ``kwargs``; pursuit's hp is 1 everywhere and it
    deals no damage, so the occupant takes seeded random hp (its bodies
    are disjoint: its sums stay exact) and the rank sweep a dense form, each
    run of 4 sorted rows sharing a target, with integer damages 1-3."""
    from .. import random as rnd
    from ..builtin.config import pursuit
    from ..parallel import VecGridWorld

    placements, _ = pursuit.layout(map_size, 5)
    venv = VecGridWorld(pursuit.get_config(map_size),
                        [len(p) for p in placements], 1,
                        placements=placements, device=device)
    if not venv._step.route.seg:
        raise ValueError("map %d does not take the segmented route"
                         % map_size)
    calls = {}
    originals = {n: getattr(ap, n) for n in SEG_SPLIT_SWEEPS}

    def recorder(name):
        def rec(*args, **kwargs):
            calls[name] = ([a.clone() for a in args], dict(kwargs))
            return originals[name](*args, **kwargs)
        return rec

    for name in originals:
        setattr(ap, name, recorder(name))
    try:
        state = venv.reset(rnd.PRNGKey(4))
        venv.observe_all(state)
        venv.transition(state, venv.random_actions(rnd.PRNGKey(5)))
    finally:
        for name, fn in originals.items():
            setattr(ap, name, fn)
    gen = torch.Generator(device="cpu").manual_seed(map_size)
    occ, occ_kw = calls["occupant_rect_seg"]
    A = occ[0].shape[0]
    occ[6] = (0.1 + 0.9 * torch.rand(A, generator=gen)).to(device)
    (tgt, rank, _, sort_y), rank_kw = calls["rank_prefix_seg"]
    shared = (torch.arange(A, device=device) // 4).to(torch.int32)
    dmg = torch.randint(1, 4, (A,), generator=gen).float().to(device)
    return [("occupant_rect_seg", occ, occ_kw),
            ("rank_prefix_seg", [shared, rank, dmg, sort_y], rank_kw)]


def _bra_target(op):
    m = re.search(r"BRA (0x[0-9a-f]+)", op)
    return int(m.group(1), 16) if m else None


def _common_path(ins, top, end):
    """The (address, instruction) pairs a loop body [top, end] runs when
    every warp-uniform branch skips its block: a branch to a later
    instruction of the body is taken; a branch back (an inner loop's back
    edge) or out of the body (an out-of-line block) is not."""
    at = {a: k for k, (a, _) in enumerate(ins)}
    path, k = [], at[top]
    while k <= at[end]:
        a, op = ins[k]
        path.append((a, op))
        target = _bra_target(op)
        if target is not None and a < target <= end:
            k = at[target]
            continue
        k += 1
    return path


# bytes of shared memory a sweep's inner loop loads per staged partner
# (one int2 for the occupant, one int for move_claims; the others load one
# 128-bit word or more)
_PARTNER_BYTES = {"occupant": 8, "move_claims": 4}


def _lds_bytes(op):
    """Bytes loaded by a SASS shared-memory load (0 for other opcodes)."""
    m = re.match(r"LDS(?:\.U)?(?:\.[SU]?(\d+))?\b", op)
    if not m:
        return 0
    return int(m.group(1)) // 8 if m.group(1) else 4


def sass_mix():
    """{kernel: [(instructions per pair, {opcode: count})]} of the split
    template's innermost loops that test 4 staged partners (shared-memory
    loads of 4 partners' records or more: 4 LDS.128 for most sweeps, 4
    LDS.64 for the occupant's, 16 bytes for move_claims') against 4
    queries each, from the built library's SASS; a kernel has one such
    loop per sweep segment.  A loop whose partners skip a warp-uniform
    block (the update of ``occupant_rect_seg`` and ``occupant``, taken only
    where a lane matched) is counted on the path that skips it."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.LIB_PATH)],
                          check=True, capture_output=True, text=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = re.search(r"(occupant_rect_seg|rank_prefix_seg|occupant_rect|"
                         r"rect_first_overlap|rank_prefix|occupant|"
                         r"move_claims)_kernel(ILb(\d))?",
                         func.split("\n", 1)[0])
        if not name:
            continue
        ins = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        addrs = {a for a, _ in ins}
        loops = []
        for a, op in ins:
            top = _bra_target(op)
            if top is None or top >= a or top not in addrs:
                continue
            path = _common_path(ins, top, a)
            body = [o for _, o in path]
            # an inner loop's back edge: this is an outer loop
            nested = any(_bra_target(o) is not None and _bra_target(o) <= b
                         for b, o in path[:-1])
            inner = [o for o in body[:-1] if "BRA" in o]
            staged = sum(_lds_bytes(re.sub(r"^@!?U?P\w+ ", "", o))
                         for o in body)
            if (staged >= 4 * _PARTNER_BYTES.get(name.group(1), 16)
                    and not nested
                    and (not inner or any("VOTE" in o for o in body))):
                mix = collections.Counter(
                    re.sub(r"^@!?U?P\w+ ", "", o).split()[0].split(".")[0]
                    for o in body)
                loops.append((len(body) / 16, dict(mix.most_common())))
        key = name.group(1) if name.group(2) is None else "%s<%s>" % (
            name.group(1), "true" if name.group(3) == "1" else "false")
        out[key] = sorted(loops, key=lambda loop: loop[0])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m magent_tpu_torch.tools.profile_rect",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--maps", type=int, nargs="*", default=[64, 500])
    parser.add_argument("--seg-maps", type=int, nargs="*", default=[1000])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        parser.error("no CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    print("%s, %d SMs" % (torch.cuda.get_device_name(device), n_sms))
    _build.lib()
    for kernel, loops in sass_mix().items():
        for per_pair, mix in loops:
            print("sass %-26s %.2f instructions per pair: %s" % (
                kernel, per_pair, mix), flush=True)
    forms = [("map %d" % m, name, a, kw) for m in args.maps
             for name, a, kw in pursuit_calls(m, device)]
    for label, (B, A), hp in (("battle", (16, 2000), False),
                              ("GridWorld", (1, 2048), True)):
        tgt, rank, dmg, hps = (t.to(device) for t in rank_operands(
            A, B, A, integer=True))
        forms.append((label, "rank_prefix", [tgt, rank, dmg] + (
            [hps] if hp else []), {"hp": hp}))
    forms.append(("battle", "occupant", [t.to(device) for t in cell_operands(
        2000, 16, 2000)], {}))
    forms.append(("GridWorld", "move_claims", [claim_operands(
        2048, 1, 2048, 125 * 125).to(device)], {}))
    forms += [("map %d" % m, name, a, kw) for m in args.seg_maps
              for name, a, kw in seg_calls(m, device)]
    for label, name, a, kw in forms:
        if name in SEG_SPLIT_SWEEPS:
            B, (A,) = 1, a[0].shape
            picked = ap.seg_split(A, kw["plan"][1], n_sms)
        else:
            B, A = a[0].shape
            picked = ap.rect_split(B, A, n_sms)
        ms = split_table(name, a, kw)
        best = min(ms, key=ms.get)
        print("%s, B=%d, A=%d, %-34s picked %s: %.4f ms; best %s: %.4f ms; "
              "all %s" % (label, B, A, form_name(name, kw), picked,
                          ms[picked], best, ms[best],
                          " ".join("%d/%d:%.4f" % (c, w, t)
                                   for (c, w), t in ms.items())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
