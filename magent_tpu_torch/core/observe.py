"""Batched observation rendering, NORTH-only path (port of
``magent_tpu/core/observe.py:93-453``).

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
``can_absorb`` observers.  Not ported: turn mode.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec as speclib
from ..ops import window_gather as wg
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


def _check_ported(spec: speclib.GameSpec):
    if spec.turn_mode:
        raise NotImplementedError(
            "turn-mode observations are ROADMAP.md Queue 1 item 11")


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


def make_grids(spec: speclib.GameSpec):
    """``state -> packed grid [B, Hp, Wp] int32``, padded for the largest
    view; ``grids.geometry`` is ``(Hp, Wp, lanes, pad_y, pad_x)``.  Each cell
    holds ``code << 24 | round(hp / hp_max * 2**23)`` (code: C = empty,
    0 = wall, group channel for an agent); every cell of a live agent's body
    rect holds its value (observe.py:124-141)."""
    H, W, C = spec.height, spec.width, spec.n_channel
    MB = spec.max_body_w
    max_vh = max(g.type.view_range.height for g in spec.groups)
    max_vw = max(g.type.view_range.width for g in spec.groups)
    Hp, Wp, lanes, pad_y, pad_x = wg.padded_geometry(H, W, C, max_vh, max_vw)
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
        B = state.x.shape[0]
        device = state.x.device
        empty = C << _HP_SHIFT
        base = torch.full((B, Hp, Wp), empty, dtype=torch.int32, device=device)
        inner = torch.where(state.cell_wall, 0, empty)
        if spec.food_mode:
            # food cells hold code 1 unless a wall is there
            # (observe.py:119-122)
            inner = torch.minimum(inner, torch.where(
                state.cell_food >= 0.0, 1 << _HP_SHIFT, empty))
        base[:, pad_y:pad_y + H, pad_x:pad_x + W] = inner.to(torch.int32)
        q = torch.round(state.hp * torch.as_tensor(inv_hp_max, device=device)
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

    grids.geometry = (Hp, Wp, lanes, pad_y, pad_x)
    return grids


def render_image(spec, group, packed, lanes):
    """packed grid ``[B, Hp, Wp]`` -> observer group's padded channel image
    ``[B, Hp, lanes]`` f32."""
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
    """Window math for one observer group: ``mask`` ([vh, vw*C] f32 on
    ``device``) and ``pos_fn(state) -> [B, cap]`` int32 top-left cells
    ``tl_y * Wp + tl_x`` in the padded image."""
    t = spec.groups[group].type
    gs = spec.groups[group]
    vr = t.view_range
    C = spec.n_channel
    Hp, Wp, lanes, pad_y, pad_x = geometry
    mask = torch.as_tensor(np.repeat(vr.mask.astype(np.float32), C, axis=1),
                           device=device)
    sl = slice(gs.offset, gs.offset + gs.cap)

    def pos_fn(state: State):
        tlx = state.x[:, sl] + t.view_x_offset + vr.x1 + pad_x
        tly = state.y[:, sl] + t.view_y_offset + vr.y1 + pad_y
        return (tly * Wp + tlx).to(torch.int32).contiguous()

    return dict(mask=mask, pos_fn=pos_fn)


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
    ``window_gather``."""
    _check_ported(spec)
    wg._check_out_dtype("make_observe", obs_dtype)
    t = spec.groups[group].type
    gs = spec.groups[group]
    vr = t.view_range
    vh, vw = vr.height, vr.width
    C = spec.n_channel
    H, W, G = spec.height, spec.width, spec.n_groups
    emb = spec.embedding_size
    perm = spec.channel_perm(group)
    sl = slice(gs.offset, gs.offset + gs.cap)

    grids_fn = make_grids(spec)
    Hp, Wp, lanes, pad_y, pad_x = grids_fn.geometry
    # minimap pooling factors (GridWorld.cc:328-329)
    scale_h = (H + vh - 1) // vh
    scale_w = (W + vw - 1) // vw
    inv_w = float(np.float32(1.0 / W))
    inv_h = float(np.float32(1.0 / H))

    rows_margin = wg._ceil_to(vh + 7, 8)
    banded = (Hp * lanes * 4 > VMEM_IMAGE_BUDGET
              and (_BAND_ROWS + rows_margin) * lanes * 4 <= _BAND_BUDGET)
    band_chunk = min(40, -(-gs.cap // 8) * 8)
    replica = (not banded and vh <= 13 and vw * C <= 65
               and 4 * Hp * lanes * 4 <= VMEM_IMAGE_BUDGET
               and Hp * Wp <= wg.PACKED_CELLS)
    # 1x1 bodies pool the rendered grid with binning matmuls; multi-cell
    # bodies, and can_absorb observers, which count only the agents not
    # absorbed, pool the anchors by a scatter (observe.py:291-326)
    binning = spec.max_body_w == 1 and not t.can_absorb
    minimap = {}
    if spec.minimap_mode:
        # pooled maps -> their observed channels (G = an all-zero map)
        chan_src = np.full(C, -1, np.int32)
        for gg in range(G):
            chan_src[perm[spec.group2channel(gg)] + 2] = gg
        mm_maskc = (chan_src >= 0).astype(np.float32)
        minimap = dict(
            mm_src=np.where(chan_src < 0, G, chan_src).astype(np.int64),
            mm_maskc=mm_maskc,
            mm_mask2d=np.tile(mm_maskc, (vh, vw)),  # [vh, vw*C]
            gof=spec.group_of_slot.astype(np.int64),
        )
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
        B = state.x.shape[0]
        px = (state.x // scale_w).clamp(0, vw - 1)
        py = (state.y // scale_h).clamp(0, vh - 1)
        if binning:
            ind = ((packed >> _HP_SHIFT)[..., None] == k["codes"]).to(
                torch.float32)  # [B, Hp, Wp, G]
            pooled = torch.einsum("rh,bhwg,wc->bgrc", k["Py"], ind, k["Px"])
            totals = pooled.sum((2, 3)).clamp_min(1.0)
            pooled = pooled / totals[:, :, None, None]  # [B, G, vh, vw]
        else:
            counted = state.active & ~state.dead
            if t.can_absorb:
                # the observer's type gates it (GridWorld.cc:341-347)
                counted = counted & ~state.absorbed
            counted = counted.to(torch.float32)
            flat = torch.zeros((B, G * vh * vw), dtype=torch.float32,
                               device=state.x.device).scatter_add_(
                1, k["gof"] * (vh * vw) + (py * vw + px).long(), counted)
            flat = flat.reshape(B, G, vh * vw)
            totals = flat.sum(-1).clamp_min(1.0)
            pooled = (flat / totals[..., None]).reshape(B, G, vh, vw)
        pooled_ext = torch.cat([pooled, torch.zeros_like(pooled[:, :1])], 1)
        return pooled_ext[:, k["mm_src"]].permute(0, 2, 3, 1), px, py

    def observe(state: State, grids=None):
        device = state.x.device
        k = on(device)
        layout = k["layout"]
        B = state.x.shape[0]
        packed = grids_fn(state) if grids is None else grids
        img = render_image(spec, group, packed, lanes)
        pos = layout["pos_fn"](state)
        act = state.active[:, sl]
        x = state.x[:, sl]
        y = state.y[:, sl]
        epi = {}  # the epilogue's minimap operands
        if spec.minimap_mode:
            mm, px, py = pooled_minimap(state, packed, k)
            self_cell = py[:, sl] * vw + px[:, sl]
            epi = dict(mm=mm, self_cell=self_cell, mm_maskc=k["mm_maskc"])
        if replica:
            mm_ops = {}
            if spec.minimap_mode:
                pos = pos * 1024 + self_cell
                mm_ops = dict(mm_img=mm.reshape(B, vh, vw * C).contiguous(),
                              mm_mask=k["mm_mask2d"])
            else:
                pos = pos * 1024
            view = wg.window_gather4(
                img, pos.to(torch.int32).contiguous(), layout["mask"],
                act=act.to(torch.int32).contiguous(), vh=vh, vw=vw, C=C,
                Wp=Wp, out_dtype=obs_dtype, **mm_ops).reshape(
                B, gs.cap, vh, vw, C)
        elif banded:
            # the windows in slot order with the epilogue applied per value
            # (rounded at the kernel's store and again after the epilogue,
            # as the JAX route rounds)
            band_epi = dict(epi, self_cell=self_cell.contiguous(),
                            mm=mm.contiguous()) if epi else {}
            view = wg.window_gather_banded(
                img, pos, layout["mask"], vh=vh, vw=vw, C=C, Wp=Wp,
                chunk=band_chunk, band_rows=_BAND_ROWS, out_dtype=obs_dtype,
                act=act.to(torch.int32).contiguous(), **band_epi).reshape(
                B, gs.cap, vh, vw, C)
        else:
            view = wg.window_gather(img, pos, layout["mask"], vh=vh, vw=vw,
                                    C=C, Wp=Wp, out_dtype=obs_dtype).reshape(
                B, gs.cap, vh, vw, C)
            view = wg.window_epilogue(view, act, **epi).to(obs_dtype)

        # feature vector (GridWorld.cc:386-396)
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
            # x * f32(1/W), not x / W: the jitted JAX package's compiler
            # folds the division by a constant into this multiply, and the
            # features are held to it bit for bit
            feats.append((x.to(torch.float32) * inv_w)[..., None])
            feats.append((y.to(torch.float32) * inv_h)[..., None])
        if spec.goal_mode:
            feats.append(torch.zeros((B, gs.cap, 2), device=device))
        feature = torch.cat(feats, -1) * act[:, :, None]
        return view, feature

    observe.grids_fn = grids_fn
    observe.route = ("window_gather_banded" if banded else "window_gather4"
                     if replica else "window_gather")
    return observe
