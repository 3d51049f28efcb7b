"""Batched observation rendering (port of ``magent_tpu/core/observe.py``):
the NORTH-only path (``:93-453``) and, for turn mode, the rotating path
(``:457-803``).

Replaces the reference's per-agent window scan (reference:
Map::extract_view, src/gridworld/Map.cc:129-207 driven by
GridWorld::get_observation, GridWorld.cc:292-401) with render-then-slice:

1. scatter each live agent's packed value ``code << 24 | round(hp/hp_max *
   2**23)`` into a padded cell grid shared by all observer groups;
2. expand the grid into the observer group's padded channel image
   ``[B, Hp, Wp * C]`` by compares against constant channel tables (the
   observer's channel permutation, GridWorld.cc:897-913, is folded in);
3. slice every agent's ``(vh, vw * C)`` window out of the image with a
   window kernel (:mod:`magent_tpu_torch.ops.window_gather`), times the
   view-range mask;
4. add the pooled minimap channels and the self mark, build the feature
   vector (GridWorld.cc:327-400) and zero dead slots.

Images above ``VMEM_IMAGE_BUDGET`` (pursuit from map 500) take
``window_gather_banded``; images of at most a quarter of it with windows
up to 13 rows and 65 lanes (forest's and pursuit's, pursuit to map
210) take ``window_gather4``.  Both fuse step 4's minimap adds, self
mark and liveness factor into the copy; larger windows (battle's 13 x 91)
and images between the two take ``window_gather`` and a separate
epilogue.
Multi-cell bodies render every body cell, food cells render as code 1,
and the minimap pools by a scatter for multi-cell bodies and for
``can_absorb`` observers.

Turn mode renders the map once into a square frame, stacks its four
rotations into one image ``[B, 4 * Hp, lanes]`` (a padded band per
facing) and slices every agent's window from its facing's band: with
``window_gather`` where the stacked image fits ``VMEM_IMAGE_BUDGET``,
with ``window_gather_banded`` where it does not, and by a per-direction
gather in plain PyTorch where even a band exceeds ``_BAND_BUDGET``
(:func:`make_observe`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec as speclib
from ..ops import window_gather as wg
from ..spans import span
from . import geometry as geo
from .state import State

# packed cell encoding: channel code in the high bits, normalized hp as a
# 24-bit fixed-point fraction in the low bits; "one" is 2**23 so a full-hp
# agent decodes to exactly 1.0
_HP_SHIFT = 24
_HP_MASK = (1 << _HP_SHIFT) - 1
_HP_SCALE = float(1 << (_HP_SHIFT - 1))

# images of more bytes per env take the banded window gather, as in the JAX
# package (magent_tpu/core/observe.py:39, whose TPU kernel holds one image
# in VMEM); module-level, so tests can shrink it to force the banded route
VMEM_IMAGE_BUDGET = 6 * 1024 * 1024
_BAND_ROWS = 32
# a band and its window margin must fit this many bytes (observe.py:251)
_BAND_BUDGET = 8 * 1024 * 1024


def _channel_tables(spec: speclib.GameSpec, group: int):
    """``inv_has[c]``: canonical channel whose presence lights observed
    channel c, or -1; ``inv_hp[c]``: canonical group channel whose hp fills
    observed channel c, or -1."""
    C = spec.n_channel
    perm = spec.channel_perm(group)
    inv_has = np.full(C, -1, np.int32)
    inv_hp = np.full(C, -1, np.int32)
    inv_has[0] = 0  # wall
    if spec.food_mode:
        inv_has[1] = 1
    for gg in range(spec.n_groups):
        orig = spec.group2channel(gg)
        inv_has[perm[orig]] = orig
        inv_hp[perm[orig] + 1] = orig
    return inv_has, inv_hp


def _packer(spec: speclib.GameSpec, Hp: int, Wp: int, pad_y: int,
            pad_x: int):
    """``state -> packed grid [B, Hp, Wp] int32`` holding map cell (y, x) at
    (y + pad_y, x + pad_x).  Each cell holds ``code << 24 | round(hp /
    hp_max * 2**23)`` (code: C = empty, 0 = wall, 1 = food, group channel
    for an agent); every cell of a live agent's body rect (its facing's
    footprint) holds its value (observe.py:114-141, :546-571)."""
    H, W, C = spec.height, spec.width, spec.n_channel
    MB = spec.max_body_w
    agent_ch = (spec.channel_base
                + spec.group_of_slot * spec.channel_scale).astype(np.int32)
    if int(agent_ch.max()) >= 64 or C >= 64:
        raise ValueError("channel codes must fit 6 bits")
    # hp * f32(1/hp_max), not hp / hp_max: the jitted JAX package's compiler
    # folds the division by a constant into this multiply, and the rounded
    # fixed-point hp is held to it bit for bit
    inv_hp_max = np.float32(1.0) / np.asarray(spec.s_hp_max, np.float32)
    consts: dict = {}

    def body_tables(device):
        """Body-cell offsets (i, j) of the max_body^2 scan [MB*MB, 1, 1] and
        the per-slot body width and length [A], on ``device``."""
        if device not in consts:
            offs = np.arange(MB, dtype=np.int32)
            consts[device] = tuple(
                torch.as_tensor(a, device=device) for a in (
                    np.repeat(offs, MB)[:, None, None],
                    np.tile(offs, MB)[:, None, None],
                    spec.s_width, spec.s_length))
        return consts[device]

    def grids(state: State):
        with span("observe.grids"):
            B = state.x.shape[0]
            device = state.x.device
            empty = C << _HP_SHIFT
            base = torch.full((B, Hp, Wp), empty, dtype=torch.int32,
                              device=device)
            inner = torch.where(state.cell_wall, 0, empty)
            if spec.food_mode:
                # food cells hold code 1 unless a wall is there
                # (observe.py:119-122)
                inner = torch.minimum(inner, torch.where(
                    state.cell_food >= 0.0, 1 << _HP_SHIFT, empty))
            base[:, pad_y:pad_y + H, pad_x:pad_x + W] = inner.to(torch.int32)
            q = torch.round(state.hp
                            * torch.as_tensor(inv_hp_max, device=device)
                            * _HP_SCALE).to(torch.int32).clamp(0, _HP_MASK)
            vals = (torch.as_tensor(agent_ch, device=device) << _HP_SHIFT) | q
            ok = state.active & ~state.dead
            # one scatter of every body cell; cells outside a body and dead
            # agents write to a dump cell past the end (live bodies are
            # disjoint, so only the dump cell sees duplicate writes)
            if MB > 1:
                i, j, width, length = body_tables(device)
                bw, bh = geo.size_for_dir(state.dir, width, length)
                ok = ok & (i < bw) & (j < bh)  # [MB*MB, B, A]
                cell = torch.where(ok, (state.y + j + pad_y) * Wp
                                   + (state.x + i + pad_x), Hp * Wp)
                cell = cell.permute(1, 0, 2).reshape(B, -1)
                vals = vals.repeat(1, MB * MB)
            else:
                cell = torch.where(ok, (state.y + pad_y) * Wp
                                   + (state.x + pad_x), Hp * Wp)
            flat = torch.cat([base.reshape(B, Hp * Wp),
                              torch.zeros((B, 1), dtype=torch.int32,
                                          device=device)], 1)
            flat.scatter_(1, cell.long(), vals.to(torch.int32))
            return flat[:, :Hp * Wp].reshape(B, Hp, Wp)

    return grids


def make_grids(spec: speclib.GameSpec):
    """``state -> packed grid [B, Hp, Wp] int32`` (:func:`_packer`), padded
    for the largest view; ``grids.geometry`` is ``(Hp, Wp, lanes, pad_y,
    pad_x)``."""
    max_vh = max(g.type.view_range.height for g in spec.groups)
    max_vw = max(g.type.view_range.width for g in spec.groups)
    geometry = wg.padded_geometry(spec.height, spec.width, spec.n_channel,
                                  max_vh, max_vw)
    Hp, Wp, lanes, pad_y, pad_x = geometry
    grids = _packer(spec, Hp, Wp, pad_y, pad_x)
    grids.geometry = geometry
    return grids


def render_image(spec, group, packed, lanes):
    """packed grid ``[B, Hp, Wp]`` -> observer group's padded channel image
    ``[B, Hp, lanes]`` f32."""
    with span("observe.render"):
        C = spec.n_channel
        inv_has, inv_hp = (torch.as_tensor(t, device=packed.device)
                           for t in _channel_tables(spec, group))
        B, Hp, Wp = packed.shape
        code = (packed >> _HP_SHIFT)[..., None]
        hpv = (packed & _HP_MASK).to(torch.float32) * (1.0 / _HP_SCALE)
        img = ((code == inv_has).to(torch.float32)
               + (code == inv_hp).to(torch.float32) * hpv[..., None])
        img = img.reshape(B, Hp, Wp * C)
        if lanes != Wp * C:
            img = torch.nn.functional.pad(img, (0, lanes - Wp * C))
        return img


def window_layout(spec: speclib.GameSpec, group: int, geometry, device):
    """Window math and route of one observer group, as :func:`make_observe`
    takes them (JAX ``core/observe.py:168-195``; shared with the profilers
    so that they measure the path that runs): ``vh``, ``vw``; ``mask`` ([vh, vw*C]
    f32 on ``device``); ``pos_fn(state) -> [B, cap]`` int32 top-left cells
    ``tl_y * Wp + tl_x`` in the padded image; ``banded`` (the group takes
    ``window_gather_banded``) and its ``chunk``; ``replica_ok`` (it takes
    ``window_gather4``).  The routes read ``VMEM_IMAGE_BUDGET`` and
    ``_BAND_BUDGET`` when called."""
    t = spec.groups[group].type
    gs = spec.groups[group]
    vr = t.view_range
    vh, vw = vr.height, vr.width
    C = spec.n_channel
    Hp, Wp, lanes, pad_y, pad_x = geometry
    mask = torch.as_tensor(np.repeat(vr.mask.astype(np.float32), C, axis=1),
                           device=device)
    sl = slice(gs.offset, gs.offset + gs.cap)

    def pos_fn(state: State):
        tlx = state.x[:, sl] + t.view_x_offset + vr.x1 + pad_x
        tly = state.y[:, sl] + t.view_y_offset + vr.y1 + pad_y
        return (tly * Wp + tlx).to(torch.int32).contiguous()

    rows_margin = wg._ceil_to(vh + 7, 8)
    banded = (Hp * lanes * 4 > VMEM_IMAGE_BUDGET
              and (_BAND_ROWS + rows_margin) * lanes * 4 <= _BAND_BUDGET)
    replica = (not banded and vh <= 13 and vw * C <= 65
               and 4 * Hp * lanes * 4 <= VMEM_IMAGE_BUDGET
               and Hp * Wp <= wg.PACKED_CELLS)
    return dict(vh=vh, vw=vw, mask=mask, pos_fn=pos_fn, banded=banded,
                chunk=min(40, -(-gs.cap // 8) * 8), replica_ok=replica)


def _minimap_tables(spec: speclib.GameSpec, group: int, vh: int, vw: int):
    """The minimap's constant tables for one observer group (numpy):
    ``mm_src`` the pooled map of each observed channel (G, an all-zero
    map, for the others), ``mm_maskc`` [C] the minimap channels,
    ``mm_mask2d`` [vh, vw*C] the same per window lane, ``gof`` the group
    of every slot."""
    C, G = spec.n_channel, spec.n_groups
    perm = spec.channel_perm(group)
    chan_src = np.full(C, -1, np.int32)
    for gg in range(G):
        chan_src[perm[spec.group2channel(gg)] + 2] = gg
    mm_maskc = (chan_src >= 0).astype(np.float32)
    return dict(mm_src=np.where(chan_src < 0, G, chan_src).astype(np.int64),
                mm_maskc=mm_maskc, mm_mask2d=np.tile(mm_maskc, (vh, vw)),
                gof=spec.group_of_slot.astype(np.int64))


def _pool_by_scatter(state: State, can_absorb: bool, G, vh, vw, scale_h,
                     scale_w, gof):
    """The pooled minimaps by one scatter of the agents' anchors
    (GridWorld.cc:327-384) -> (pooled [B, G, vh, vw], px, py [B, A] the
    pooled cell of every slot).  Dead agents are not counted, nor, for a
    ``can_absorb`` observer (its type gates it, GridWorld.cc:341-347), the
    absorbed ones."""
    B = state.x.shape[0]
    px = (state.x // scale_w).clamp(0, vw - 1)
    py = (state.y // scale_h).clamp(0, vh - 1)
    counted = state.active & ~state.dead
    if can_absorb:
        counted = counted & ~state.absorbed
    flat = torch.zeros((B, G * vh * vw), dtype=torch.float32,
                       device=state.x.device).scatter_add_(
        1, gof * (vh * vw) + (py * vw + px).long(),
        counted.to(torch.float32)).reshape(B, G, vh * vw)
    totals = flat.sum(-1).clamp_min(1.0)
    return (flat / totals[..., None]).reshape(B, G, vh, vw), px, py


def _minimap_channels(pooled, mm_src):
    """Pooled maps [B, G, vh, vw] -> the observed channels [B, vh, vw, C]
    (zero outside the minimap channels)."""
    ext = torch.cat([pooled, torch.zeros_like(pooled[:, :1])], 1)
    return ext[:, mm_src].permute(0, 2, 3, 1)


def _features(spec: speclib.GameSpec, group: int, state: State):
    """The feature vector [B, cap, F] (GridWorld.cc:386-396), zero for
    inactive slots."""
    with span("observe.features"):
        t = spec.groups[group].type
        gs = spec.groups[group]
        sl = slice(gs.offset, gs.offset + gs.cap)
        device = state.x.device
        B = state.x.shape[0]
        emb = spec.embedding_size
        feats = []
        if emb > 0:
            ids = state.id[:, sl]
            shifts = torch.arange(emb, dtype=ids.dtype, device=device)
            feats.append(((ids[..., None] >> shifts) & 1).to(torch.float32))
        # one-hot that maps the out-of-range reset action to all zeros
        feats.append((state.last_action[:, sl][..., None] == torch.arange(
            t.n_action, device=device)).to(torch.float32))
        feats.append(state.last_reward[:, sl][..., None])
        if spec.minimap_mode:
            # x * f32(1/W), not x / W: the jitted JAX package's compiler folds
            # the division by a constant into this multiply, and the features
            # are held to it bit for bit
            inv_w = float(np.float32(1.0 / spec.width))
            inv_h = float(np.float32(1.0 / spec.height))
            feats.append(
                (state.x[:, sl].to(torch.float32) * inv_w)[..., None])
            feats.append(
                (state.y[:, sl].to(torch.float32) * inv_h)[..., None])
        if spec.goal_mode:
            feats.append(torch.zeros((B, gs.cap, 2), device=device))
        return torch.cat(feats, -1) * state.active[:, sl, None]


def make_observe(spec: speclib.GameSpec, group: int,
                 obs_dtype=torch.float32):
    """Build ``observe(state, grids=None) -> (view [B, cap, vh, vw, C],
    feature [B, cap, F])`` for one group; ``grids`` lets callers share the
    packed grid (``observe.grids_fn(state)``) across groups.

    ``obs_dtype`` is the views' dtype, ``torch.float32`` or
    ``torch.bfloat16`` (the JAX package's ``obs_dtype``); features stay f32.
    bf16 views round where the JAX package's kernel route rounds
    (observe.py:346-401): ``window_gather4`` once, after its fused
    epilogue; ``window_gather`` and ``window_gather_banded`` at the kernel's
    store, then the epilogue runs in f32 (bf16 + f32 promotes) and the
    result is rounded again.

    Three window routes mirror the JAX package's kernel per path, so that
    each path runs the kernel the reference runs there; the image budget
    and the window shape limit are the TPU's, not limits of the card.  An
    image of more than ``VMEM_IMAGE_BUDGET`` bytes per env whose band
    fits takes ``window_gather_banded``, which writes each window to its
    slot with the epilogue (minimap, self mark, liveness) applied per
    value, where the JAX package applies it in band order and gathers the
    rows back (observe.py:244-258, :370-404): pursuit at map 500 and 1000.
    Windows with ``vh <= 13`` and ``vw * C <= 65`` whose image, four
    times over, fits the budget (``4 * image_bytes <= VMEM_IMAGE_BUDGET``:
    the TPU kernel holds four shifted replicas) take ``window_gather4``
    with the liveness factor, and with the minimap and self mark when
    ``minimap_mode`` is on (the replica route, observe.py:263-267 and
    :346-360, which fuses liveness only together with the minimap; views
    are non-negative and the factor is 0 or 1, so the numbers are the
    same); others below the budget take ``window_gather`` and the
    epilogue in PyTorch, so bf16 views round where the JAX package's do.
    ``window_gather4`` packs ``tl * 1024 + self_cell`` into int32, so it
    serves only images of at most 2**21 cells; larger images take
    ``window_gather``.

    Turn mode takes the rotating observation (:func:`_make_observe_rotating`,
    routed as the JAX package's ``_make_observe_rotating``); it renders its
    own frame, so its ``grids_fn`` is None and ``grids`` is ignored."""
    wg._check_out_dtype("make_observe", obs_dtype)
    if spec.turn_mode:
        return _make_observe_rotating(spec, group, obs_dtype)
    t = spec.groups[group].type
    gs = spec.groups[group]
    vr = t.view_range
    vh, vw = vr.height, vr.width
    C = spec.n_channel
    H, W, G = spec.height, spec.width, spec.n_groups
    sl = slice(gs.offset, gs.offset + gs.cap)

    grids_fn = make_grids(spec)
    Hp, Wp, lanes, pad_y, pad_x = grids_fn.geometry
    # minimap pooling factors (GridWorld.cc:328-329)
    scale_h = (H + vh - 1) // vh
    scale_w = (W + vw - 1) // vw

    route = window_layout(spec, group, grids_fn.geometry, "cpu")
    banded, replica = route["banded"], route["replica_ok"]
    band_chunk = route["chunk"]
    # 1x1 bodies pool the rendered grid with binning matmuls; multi-cell
    # bodies, and can_absorb observers, which count only the agents not
    # absorbed, pool the anchors by a scatter (observe.py:291-326)
    binning = spec.max_body_w == 1 and not t.can_absorb
    minimap = {}
    if spec.minimap_mode:
        minimap = _minimap_tables(spec, group, vh, vw)
        if binning:
            # 0/1 binning matrices: every live agent occupies one cell
            # marked with its group's code, so the pooled counts are
            # Py @ ind @ Px^T
            Py = np.zeros((vh, Hp), np.float32)
            Px = np.zeros((Wp, vw), np.float32)
            for yy in range(H):
                Py[min(yy // scale_h, vh - 1), pad_y + yy] = 1.0
            for xx in range(W):
                Px[pad_x + xx, min(xx // scale_w, vw - 1)] = 1.0
            minimap.update(Py=Py, Px=Px, codes=(
                spec.channel_base
                + np.arange(G) * spec.channel_scale).astype(np.int32))
    consts: dict = {}

    def on(device):
        if device not in consts:
            k = {name: torch.as_tensor(v, device=device)
                 for name, v in minimap.items()}
            k["layout"] = window_layout(spec, group, grids_fn.geometry, device)
            consts[device] = k
        return consts[device]

    def pooled_minimap(state: State, packed, k):
        """-> (mm [B, vh, vw, C] pooled minimap channels, px, py [B, A] the
        pooled cells of every slot), GridWorld.cc:327-384; dead agents are
        not counted."""
        with span("observe.minimap"):
            if not binning:
                pooled, px, py = _pool_by_scatter(
                    state, t.can_absorb, G, vh, vw, scale_h, scale_w,
                    k["gof"])
                return _minimap_channels(pooled, k["mm_src"]), px, py
            px = (state.x // scale_w).clamp(0, vw - 1)
            py = (state.y // scale_h).clamp(0, vh - 1)
            ind = ((packed >> _HP_SHIFT)[..., None] == k["codes"]).to(
                torch.float32)  # [B, Hp, Wp, G]
            pooled = torch.einsum("rh,bhwg,wc->bgrc", k["Py"], ind, k["Px"])
            totals = pooled.sum((2, 3)).clamp_min(1.0)
            pooled = pooled / totals[:, :, None, None]  # [B, G, vh, vw]
            return _minimap_channels(pooled, k["mm_src"]), px, py

    def observe(state: State, grids=None):
        k = on(state.x.device)
        layout = k["layout"]
        B = state.x.shape[0]
        packed = grids_fn(state) if grids is None else grids
        img = render_image(spec, group, packed, lanes)
        epi = {}  # the epilogue's minimap operands
        if spec.minimap_mode:
            mm, px, py = pooled_minimap(state, packed, k)
            self_cell = py[:, sl] * vw + px[:, sl]
            epi = dict(mm=mm, self_cell=self_cell, mm_maskc=k["mm_maskc"])
        with span("observe.window"):
            pos = layout["pos_fn"](state)
            act = state.active[:, sl]
            if replica:
                mm_ops = {}
                if spec.minimap_mode:
                    pos = pos * 1024 + self_cell
                    mm_ops = dict(
                        mm_img=mm.reshape(B, vh, vw * C).contiguous(),
                        mm_mask=k["mm_mask2d"])
                else:
                    pos = pos * 1024
                view = wg.window_gather4(
                    img, pos.to(torch.int32).contiguous(), layout["mask"],
                    act=act.to(torch.int32).contiguous(), vh=vh, vw=vw, C=C,
                    Wp=Wp, out_dtype=obs_dtype, **mm_ops).reshape(
                    B, gs.cap, vh, vw, C)
            elif banded:
                # the windows in slot order with the epilogue applied per
                # value (rounded at the kernel's store and again after the
                # epilogue, as the JAX route rounds)
                view = _banded_view(img, pos, layout["mask"], act, epi,
                                    vh=vh, vw=vw, C=C, Wp=Wp,
                                    chunk=band_chunk, out_dtype=obs_dtype)
            else:
                view = wg.window_gather(
                    img, pos, layout["mask"], vh=vh, vw=vw, C=C, Wp=Wp,
                    out_dtype=obs_dtype).reshape(B, gs.cap, vh, vw, C)
                view = wg.window_epilogue(view, act, **epi).to(obs_dtype)
        return view, _features(spec, group, state)

    observe.grids_fn = grids_fn
    observe.route = ("window_gather_banded" if banded else "window_gather4"
                     if replica else "window_gather")
    return observe


def _banded_view(img, pos, mask, act, epi, *, vh, vw, C, Wp, chunk,
                 out_dtype):
    """``window_gather_banded`` in slot order with the observation's
    epilogue (liveness ``act`` [B, n] bool, and the minimap operands
    ``epi`` when there are any) fused -> views [B, n, vh, vw, C]."""
    B, n = pos.shape
    if epi:
        epi = dict(epi, self_cell=epi["self_cell"].to(torch.int32)
                   .contiguous(), mm=epi["mm"].contiguous())
    return wg.window_gather_banded(
        img, pos, mask, vh=vh, vw=vw, C=C, Wp=Wp, chunk=chunk,
        band_rows=_BAND_ROWS, out_dtype=out_dtype,
        act=act.to(torch.int32).contiguous(), **epi).reshape(B, n, vh, vw, C)


# ------------------------------------------------------------------ turn mode
def _make_observe_rotating(spec: speclib.GameSpec, group: int, obs_dtype):
    """The turn-mode observation, routed as the JAX package's
    ``_make_observe_rotating`` (observe.py:475-510): per group, the padded
    geometry of a square frame of side ``S = max(H, W)``; the four-band
    stacked image of ``4 * Hp * lanes * 4`` bytes within
    ``VMEM_IMAGE_BUDGET`` takes ``window_gather``, a larger one whose band
    and window margin fit ``_BAND_BUDGET`` takes ``window_gather_banded``,
    and the rest the per-direction gather (:func:`_make_observe_dirs`)."""
    vr = spec.groups[group].type.view_range
    S = max(spec.height, spec.width)
    geom = wg.padded_geometry(S, S, spec.n_channel, vr.height, vr.width)
    stacked = 4 * geom[0] * geom[2] * 4 <= VMEM_IMAGE_BUDGET
    rows_margin = wg._ceil_to(vr.height + 7, 8)
    band_fits = (_BAND_ROWS + rows_margin) * geom[2] * 4 <= _BAND_BUDGET
    if not (stacked or band_fits):
        return _make_observe_dirs(spec, group, obs_dtype)
    return _make_observe_stacked(spec, group, geom, obs_dtype,
                                 banded=not stacked)


def _make_observe_stacked(spec: speclib.GameSpec, group: int, geom,
                          obs_dtype, banded: bool):
    """The stacked-rotations route (observe.py:513-688): the packed cells
    rendered once into an unpadded square frame ``F`` [B, S, S], its four
    view-frame rotations stacked row-wise into one packed image, one
    padded band per facing in the direction enum's order (EAST, SOUTH,
    WEST, NORTH), rendered into the group's channel image [B, 4 * Hp,
    lanes]; every agent's window is the axis-aligned one in its facing's
    band.  With the eye (ex, ey) (``save_to_real``, ``rela_to_abs``) and
    the view bounds (x1, y1), the window's top-left in band d is::

        EAST   F(x', S-1-y')      ty = S-1-ex + y1   tx = ey + x1
        SOUTH  F(S-1-y', S-1-x')  ty = S-1-ey + y1   tx = S-1-ex + x1
        WEST   F(S-1-x', y')      ty = ex + y1       tx = S-1-ey + x1
        NORTH  F(y', x')          ty = ey + y1       tx = ex + x1

    The windows come from ``window_gather`` and then the epilogue in
    PyTorch, or from ``window_gather_banded`` with the epilogue fused
    (``banded``): both round bf16 views at the kernel's store and again
    after the epilogue, as the JAX route does.  The minimap always pools
    by a scatter (observe.py:626-657)."""
    t = spec.groups[group].type
    gs = spec.groups[group]
    vr = t.view_range
    vh, vw = vr.height, vr.width
    C, G = spec.n_channel, spec.n_groups
    H, W = spec.height, spec.width
    S = max(H, W)
    Hp, Wp, lanes, pad_y, pad_x = geom
    sl = slice(gs.offset, gs.offset + gs.cap)
    scale_h = (H + vh - 1) // vh
    scale_w = (W + vw - 1) // vw
    band_chunk = min(40, wg._ceil_to(gs.cap, 8))
    frame_fn = _packer(spec, S, S, 0, 0)
    tables = dict(mask=np.repeat(vr.mask.astype(np.float32), C, axis=1))
    if spec.minimap_mode:
        tables.update(_minimap_tables(spec, group, vh, vw))
    consts: dict = {}

    def on(device):
        if device not in consts:
            consts[device] = {name: torch.as_tensor(v, device=device)
                              for name, v in tables.items()}
        return consts[device]

    def stacked_image(state: State):
        F = frame_fn(state)  # [B, S, S]
        B = F.shape[0]
        rots = torch.stack([
            F.transpose(1, 2).flip(1),  # EAST
            F.flip((1, 2)),  # SOUTH
            F.flip(1).transpose(1, 2),  # WEST
            F,  # NORTH
        ], 1)
        bands = torch.full((B, 4, Hp, Wp), C << _HP_SHIFT, dtype=torch.int32,
                           device=F.device)
        bands[:, :, pad_y:pad_y + S, pad_x:pad_x + S] = rots
        return render_image(spec, group, bands.reshape(B, 4 * Hp, Wp), lanes)

    def window_pos(state: State):
        """Each agent's window top-left in its facing's band, ``tl_y * Wp +
        tl_x`` of the stacked image [B, cap] int32."""
        d = state.dir[:, sl]
        rx, ry = geo.save_to_real(state.x[:, sl], state.y[:, sl], d,
                                  t.width, t.length)
        ex, ey = geo.rela_to_abs(rx, ry, d, t.view_x_offset,
                                 t.view_y_offset)
        is_e, is_s, is_w = (d == speclib.EAST), (d == speclib.SOUTH), (
            d == speclib.WEST)
        ty = torch.where(is_e, S - 1 - ex, torch.where(
            is_s, S - 1 - ey, torch.where(is_w, ex, ey))) + vr.y1
        tx = torch.where(is_e, ey, torch.where(
            is_s, S - 1 - ex, torch.where(is_w, S - 1 - ey, ex))) + vr.x1
        return ((d * Hp + pad_y + ty) * Wp + pad_x + tx).to(
            torch.int32).contiguous()

    def observe(state: State, grids=None):
        k = on(state.x.device)
        B = state.x.shape[0]
        img = stacked_image(state)
        pos = window_pos(state)
        act = state.active[:, sl]
        epi = {}
        if spec.minimap_mode:
            pooled, px, py = _pool_by_scatter(state, t.can_absorb, G, vh, vw,
                                              scale_h, scale_w, k["gof"])
            epi = dict(mm=_minimap_channels(pooled, k["mm_src"]),
                       self_cell=py[:, sl] * vw + px[:, sl],
                       mm_maskc=k["mm_maskc"])
        with span("observe.window"):
            if banded:
                view = _banded_view(img, pos, k["mask"], act, epi, vh=vh,
                                    vw=vw, C=C, Wp=Wp, chunk=band_chunk,
                                    out_dtype=obs_dtype)
            else:
                view = wg.window_gather(
                    img, pos, k["mask"], vh=vh, vw=vw, C=C, Wp=Wp,
                    out_dtype=obs_dtype).reshape(B, gs.cap, vh, vw, C)
                view = wg.window_epilogue(view, act, **epi).to(obs_dtype)
        return view, _features(spec, group, state)

    observe.grids_fn = None
    observe.geometry = geom
    observe.route = "window_gather_banded" if banded else "window_gather"
    return observe


def _dir_offset_tables(t: speclib.AgentTypeSpec):
    """``offs[d, vy, vx]``: the map offset of view cell (vy, vx) from the
    eye of an agent facing d (observe.py:457-472; rotation per Map.cc:515-532)
    -> (offs_x, offs_y) [4, vh, vw] int32."""
    vr = t.view_range
    vh, vw = vr.height, vr.width
    rx = np.broadcast_to(np.arange(vw)[None, :] + vr.x1, (vh, vw))
    ry = np.broadcast_to(np.arange(vh)[:, None] + vr.y1, (vh, vw))
    offs_x = np.zeros((4, vh, vw), np.int32)
    offs_y = np.zeros((4, vh, vw), np.int32)
    offs_x[speclib.NORTH], offs_y[speclib.NORTH] = rx, ry
    offs_x[speclib.SOUTH], offs_y[speclib.SOUTH] = -rx, -ry
    offs_x[speclib.WEST], offs_y[speclib.WEST] = ry, -rx
    offs_x[speclib.EAST], offs_y[speclib.EAST] = -ry, rx
    return offs_x, offs_y


def _make_observe_dirs(spec: speclib.GameSpec, group: int, obs_dtype):
    """The per-direction route (observe.py:691-803), plain PyTorch, as the
    JAX package runs it without a kernel: every view cell read from the
    occupancy grid ``state.cell_slot`` at the eye plus its facing's offset
    (:func:`_dir_offset_tables`), the hp as ``hp / hp_max`` unquantized;
    the minimap channels set to the pooled map plus the self mark.  Serves
    frames whose band exceeds ``_BAND_BUDGET``."""
    t = spec.groups[group].type
    gs = spec.groups[group]
    vr = t.view_range
    vh, vw = vr.height, vr.width
    C, A, G = spec.n_channel, spec.n_agents_cap, spec.n_groups
    H, W = spec.height, spec.width
    sl = slice(gs.offset, gs.offset + gs.cap)
    scale_h = (H + vh - 1) // vh
    scale_w = (W + vw - 1) // vw
    perm = spec.channel_perm(group)
    offs_x, offs_y = _dir_offset_tables(t)
    mm_ch = [int(perm[spec.group2channel(gg)]) + 2 for gg in range(G)]
    tables = dict(
        gof=spec.group_of_slot.astype(np.int64),
        perm_ext=np.concatenate([perm, [C]]).astype(np.int64),
        hp_max=np.asarray(spec.g_hp_max, np.float32),
        offs_x=offs_x, offs_y=offs_y, range_mask=vr.mask.astype(bool))
    consts: dict = {}

    def on(device):
        if device not in consts:
            consts[device] = {name: torch.as_tensor(v, device=device)
                              for name, v in tables.items()}
        return consts[device]

    def observe(state: State, grids=None):
        k = on(state.x.device)
        B = state.x.shape[0]
        device = state.x.device
        occ = state.cell_slot.reshape(B, H * W)
        is_agent = occ >= 0
        occ_g = k["gof"][occ.clamp(0, A - 1).long()]
        ch = torch.where(
            state.cell_wall.reshape(B, H * W), 0, torch.where(
                state.cell_food.reshape(B, H * W) >= 0.0,
                1 if spec.food_mode else -1,
                torch.where(is_agent, spec.channel_base
                            + occ_g * spec.channel_scale, -1)))
        pch = k["perm_ext"][torch.where(ch >= 0, ch, C).long()]
        hp_grid = torch.where(is_agent, torch.gather(
            state.hp, 1, occ.clamp(0, A - 1).long()) / k["hp_max"][occ_g],
            0.0)

        d = state.dir[:, sl].long()
        rx, ry = geo.save_to_real(state.x[:, sl], state.y[:, sl],
                                  state.dir[:, sl], t.width, t.length)
        ex, ey = geo.rela_to_abs(rx, ry, state.dir[:, sl], t.view_x_offset,
                                 t.view_y_offset)
        gx = ex[..., None, None] + k["offs_x"][d]  # [B, cap, vh, vw]
        gy = ey[..., None, None] + k["offs_y"][d]
        inb = (gx >= 0) & (gx < W) & (gy >= 0) & (gy < H)
        cell = (gy.clamp(0, H - 1) * W + gx.clamp(0, W - 1)).reshape(
            B, -1).long()

        def at(grid):
            return torch.gather(grid, 1, cell).reshape(gx.shape)

        cell_ch = at(pch)
        valid = inb & k["range_mask"] & (cell_ch < C)
        chans = torch.arange(C, device=device)
        onehot = (torch.where(valid, cell_ch, C)[..., None] == chans).to(
            torch.float32)
        hp_onehot = (torch.where(valid & at(is_agent), cell_ch + 1, C)[
            ..., None] == chans).to(torch.float32)
        view = onehot + hp_onehot * at(hp_grid)[..., None]

        if spec.minimap_mode:
            pooled, px, py = _pool_by_scatter(state, t.can_absorb, G, vh, vw,
                                              scale_h, scale_w, k["gof"])
            self_mark = (((py[:, sl] * vw + px[:, sl])[..., None]
                          == torch.arange(vh * vw, device=device))
                         .to(torch.float32).reshape(B, gs.cap, vh, vw))
            for gg in range(G):
                view[..., mm_ch[gg]] = pooled[:, gg, None] + self_mark
        view = (view * state.active[:, sl, None, None, None]).to(obs_dtype)
        return view, _features(spec, group, state)

    observe.grids_fn = None
    observe.route = "per_direction"
    return observe
