"""The port's CUDA kernels against their plain versions on the card (the
rect kernels and window_gather4 on the operands of a pursuit map-64, B=16
step; the rect kernels and rank_prefix (both forms) also on random and
adversarial operands at ragged sizes, in every launch split; occupant and
move_claims on random operands at ragged sizes, in every launch split;
window_gather, window_gather4 (three epilogue forms) and
window_gather_banded (three slot-order forms and band order) in f32 and
bf16 at ragged sizes, edge and outside positions, bit for bit in several
launch splits; the segmented sweeps and the banded gather
on a pursuit map-250 step;
the segmented sweeps on the random operands of tests/_torch_seg_operands.py,
occupant_rect_seg and rank_prefix_seg in every launch split;
the window-gather cost ladder on tools/profile_window.py's inputs; the
bf16 forms of the three window kernels), and short GPU-vs-CPU runs of the
lockstep loop (battle; pursuit with and without interior walls; pursuit's
one world on the segmented route; battle forced onto the banded route with
bf16 views), of the stateful GridWorld (battle; the grid path's multi-cell
bodies, food and absorb: pursuit on both routes and the golden food,
food_crumb and absorb layouts; the food sums' order; sequential mode on
the battle_melee, food_crumb and turn_bodies goldens), of the fast
DiscreteSnake at its default map (100 x 100, 256 slots) and of the
fused trainers (one step of each, f32, TF32 off: DQN from the trusty battle
weights read with numpy, A2C and DRQN from fresh seeded nets); the reward-rule plans (``GeneralRule`` whole and
chunked, ``PairSharedObjectRule``) on random states, GPU against CPU.
Marked ``gpu``: each test decides at run time whether a card exists and
skips without one.  On a machine with an H100:
python -m pytest tests/test_torch_port_gpu.py -q"""

import numpy as np
import pytest
import torch

from magent_tpu_torch import GridWorld, ops
from magent_tpu_torch import random as trandom
from magent_tpu_torch.builtin.config import battle
from magent_tpu_torch.builtin.torch_model import (DQNNet, params_from_flax,
                                                  params_to_flax)
from magent_tpu_torch.core import observe as tobserve
from magent_tpu_torch.core.state import FIELDS
from magent_tpu_torch.ops import attack_prefix as tap
from magent_tpu_torch.ops import window_gather as twg
from magent_tpu_torch.ops import window_ladder as twl
from magent_tpu_torch.parallel import (ClipAdam, VecGridWorld,
                                       make_dqn_train_step,
                                       make_dqn_train_step_remat)
from magent_tpu_torch.tools import profile_rect as tpr
from magent_tpu_torch.tools import profile_window as tpw

from _torch_seg_operands import CASES, seg_calls
from _torch_train_checks import assert_adam_steps_close, step_flat

pytestmark = pytest.mark.gpu

# f32 pair sums: slot-order sum in the kernel vs the plain reduction order
PAIR_ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _pair_inputs(A, B, seed, device):
    rng = np.random.RandomState(seed)
    cell = np.stack([rng.permutation(3 * A)[:A] for _ in range(B)])
    cell = np.where(rng.uniform(size=(B, A)) < 0.1, tap.CELL_DEAD, cell)
    acell = rng.randint(0, 3 * A, size=(B, A))
    acell = np.where(rng.uniform(size=(B, A)) < 0.2, tap.QUERY_NONE, acell)
    tcell = rng.randint(0, A, size=(B, A))
    tgt = np.where(rng.uniform(size=(B, A)) < 0.3, A, rng.randint(0, A, (B, A)))
    bits = rng.randint(0, 2**32, size=(B, A), dtype=np.uint64).astype(np.int64)
    # the engine gives no-target rows (tgt == A) zero damage; their sums
    # would otherwise grow to hundreds, past what atol 1e-5 can hold
    dmg = np.where(tgt == A, 0.0, rng.uniform(size=(B, A)))
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return dict(
        cell=as_t(cell, torch.int32), acell=as_t(acell, torch.int32),
        tcell=as_t(tcell, torch.int32), tgt=as_t(tgt, torch.int32),
        rank=tap.pack_rank(as_t(bits, torch.int64), A),
        dmg=as_t(dmg, torch.float32),
        hp=as_t(rng.uniform(size=(B, A)) * 10, torch.float32))


@pytest.mark.parametrize("A", [97, 777, 2000])
def test_pair_kernels_match_plain_on_card(cuda, A):
    x = _pair_inputs(A, 3, A, cuda)
    before = ops.launch_counts()
    got = tap.occupant(x["acell"], x["cell"], x["hp"])
    want = tap.occupant_ref(x["acell"], x["cell"], x["hp"])
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], atol=PAIR_ATOL, rtol=0)
    got = tap.rank_prefix(x["tgt"], x["rank"], x["dmg"])
    want = tap.rank_prefix_ref(x["tgt"], x["rank"], x["dmg"])
    torch.testing.assert_close(got, want, atol=PAIR_ATOL, rtol=0)
    for g, w in zip(tap.move_resolve(x["tcell"], x["cell"]),
                    tap.move_resolve_ref(x["tcell"], x["cell"])):
        assert torch.equal(g, w)
    after = ops.launch_counts()
    for name in ("occupant", "rank_prefix", "move_resolve"):
        assert after[name] == before[name] + 1


@pytest.mark.parametrize("A", [97, 777, 2048])
def test_grid_pair_kernels_match_plain_on_card(cuda, A):
    """rank_prefix's hp form (hp_t exact, sentinel rows read 0) and
    move_claims (exact on every row, sentinel rows included)."""
    x = _pair_inputs(A, 2, A + 1, cuda)
    before = ops.launch_counts()
    P, hp_t = tap.rank_prefix(x["tgt"], x["rank"], x["dmg"], x["hp"])
    want_p, want_hp = tap.rank_prefix_ref(x["tgt"], x["rank"], x["dmg"],
                                          x["hp"])
    torch.testing.assert_close(P, want_p, atol=PAIR_ATOL, rtol=0)
    assert torch.equal(hp_t, want_hp)
    assert bool((hp_t[x["tgt"] == A] == 0).all())
    tcell = torch.where(x["acell"] == tap.QUERY_NONE, 3 * A, x["tcell"])
    for g, w in zip(tap.move_claims(tcell), tap.move_claims_ref(tcell)):
        assert torch.equal(g, w)
    after = ops.launch_counts()
    assert after["rank_prefix_hp"] == before["rank_prefix_hp"] + 1
    assert after["move_claims"] == before["move_claims"] + 1
    assert after["rank_prefix"] == before["rank_prefix"]


def test_gridworld_gpu_matches_cpu(cuda):
    """The stateful API on the card and on the CPU: same placements (host
    LCG), same actions -> equal observations, rewards and states."""
    envs = [GridWorld("battle", map_size=30, device=d) for d in (cuda, "cpu")]
    for e in envs:
        e.reset()
        e.add_walls(method="random", n=12)
        for h in e.get_handles():
            e.add_agents(h, method="random", n=60)
    rng = np.random.RandomState(0)
    for _ in range(4):
        for h in envs[0].get_handles():
            (gv, gf), (cv, cf) = (e.get_observation(h) for e in envs)
            np.testing.assert_allclose(gv, cv, atol=1e-6, rtol=0)
            np.testing.assert_array_equal(gf, cf)
            acts = rng.randint(0, envs[0].get_action_space(h)[0],
                               envs[0].get_num(h)).astype(np.int32)
            for e in envs:
                e.set_action(h, acts)
        assert envs[0].step() == envs[1].step()
        for h in envs[0].get_handles():
            np.testing.assert_array_equal(envs[0].get_reward(h),
                                          envs[1].get_reward(h))
        for e in envs:
            e.clear_dead()
        for name in FIELDS:
            assert torch.equal(getattr(envs[0].state, name).cpu(),
                               getattr(envs[1].state, name)), name


def test_window_gather_matches_plain_on_card(cuda):
    spec = VecGridWorld(battle.get_config(40), [30, 30], 1, device="cpu").spec
    C = spec.n_channel
    vr = spec.groups[0].type.view_range
    Hp, Wp, lanes, pad_y, pad_x = twg.padded_geometry(40, 40, C, vr.height,
                                                      vr.width)
    g = torch.Generator(device="cpu").manual_seed(0)
    img = torch.rand((3, Hp, lanes), generator=g).to(cuda)
    xs = torch.randint(0, 40, (3, 70), generator=g) + vr.x1 + pad_x
    ys = torch.randint(0, 40, (3, 70), generator=g) + vr.y1 + pad_y
    pos = (ys * Wp + xs).to(torch.int32).to(cuda)
    mask = torch.as_tensor(np.repeat(vr.mask.astype(np.float32), C, axis=1),
                           device=cuda)
    kw = dict(vh=vr.height, vw=vr.width, C=C, Wp=Wp)
    got = twg.window_gather(img, pos, mask, **kw)
    assert torch.equal(got, twg.window_gather_ref(img, pos, mask, **kw))


# rank_prefix's ragged sizes (tests/test_torch_port_rect_split.py RANK_A)
RANK_A = (1, 2, 127, 128, 129, 153, 2000, 2048, 9375, 16384)


def _rank_plain(tgt, rank, dmg, hp):
    """rank_prefix_ref env by env (its pair mask is [A, A]: 1 GB of f32
    products per env at A=16,384)."""
    outs = [tap.rank_prefix_ref(tgt[b:b + 1], rank[b:b + 1], dmg[b:b + 1],
                                hp[b:b + 1]) for b in range(tgt.shape[0])]
    return tuple(torch.cat(o) for o in zip(*outs))


@pytest.mark.parametrize("A", RANK_A)
@pytest.mark.parametrize("B", [1, 16])
def test_rank_prefix_matches_plain_in_every_split(cuda, A, B):
    """rank_prefix in both forms, in every launch split (cluster of 1-8
    CTAs, 1-8 warps each: every split rect_split can pick and more):
    integer damages (battle's 2.0) exact, random damages within PAIR_ATOL
    (the kernel sums range by range), hp_t exact, sentinel rows included;
    the entry point launches its kernel once per call."""
    for integer in (True, False):
        tgt, rank, dmg, hp = (t.to(cuda) for t in tpr.rank_operands(
            A, B, 3 * A + B + integer, integer))
        want, want_hp = _rank_plain(tgt, rank, dmg, hp)
        assert int((want != 0).sum()) > 0 or A < 20
        for split in tpr.SPLITS:
            P = tap._rank_prefix_launch(tgt, rank, dmg, None, split)
            P_hp, hp_t = tap._rank_prefix_launch(tgt, rank, dmg, hp, split)
            if integer:
                assert torch.equal(P, want), split
            else:
                torch.testing.assert_close(P, want, atol=PAIR_ATOL, rtol=0)
            assert torch.equal(P_hp, P), split
            assert torch.equal(hp_t, want_hp), split
        before = ops.launch_counts()
        assert torch.equal(tap.rank_prefix(tgt, rank, dmg), tap.rank_prefix(
            tgt, rank, dmg, hp)[0])
        after = ops.launch_counts()
        assert after["rank_prefix"] == before["rank_prefix"] + 1
        assert after["rank_prefix_hp"] == before["rank_prefix_hp"] + 1


# the one-cell sweeps' ragged sizes (tests/test_torch_port_pair_split.py)
PAIR_A = (1, 2, 127, 128, 129, 777, 2000, 2048)
# the grid path's shared non-mover cell: H * W of a map-125 world
CLAIM_SENTINEL = 125 * 125


def _assert_occupant_equal(got, want, matches, tag):
    """The slot exactly; hp bit for bit wherever a query matches at most
    two slots, else within PAIR_ATOL (the kernel sums range by range)."""
    assert torch.equal(got[0], want[0]), tag
    few = matches <= 2
    assert torch.equal(got[1][few], want[1][few]), tag
    torch.testing.assert_close(got[1][~few], want[1][~few], atol=PAIR_ATOL,
                               rtol=0)


@pytest.mark.parametrize("A", PAIR_A)
@pytest.mark.parametrize("B", [1, 16])
def test_occupant_matches_plain_in_every_split(cuda, A, B):
    """occupant on the split template in every launch split, on unique
    cells and on duplicate cells (piles of two and more slots); the entry
    point launches its kernel once per call."""
    for duplicates in (False, True):
        acell, cell, hp = (t.to(cuda) for t in tpr.cell_operands(
            A, B, 11 * A + B + duplicates, duplicates))
        want = tap.occupant_ref(acell, cell, hp)
        matches = tpr.occupant_matches(acell, cell)
        assert int((want[0] >= 0).sum()) > 0 or A < 20
        for split in tpr.SPLITS:
            _assert_occupant_equal(tap._occupant_launch(acell, cell, hp,
                                                        split),
                                   want, matches, split)
        before = ops.launch_counts()["occupant"]
        _assert_occupant_equal(tap.occupant(acell, cell, hp), want, matches,
                               "entry point")
        assert ops.launch_counts()["occupant"] == before + 1


@pytest.mark.parametrize("A", PAIR_A)
@pytest.mark.parametrize("B", [1, 16])
def test_move_claims_matches_plain_in_every_split(cuda, A, B):
    """move_claims on the split template (the pairs i < j alone) in every
    launch split, exact, with a third of the slots at one shared sentinel
    cell; the entry point launches its kernel once per call."""
    tcell = tpr.claim_operands(A, B, 13 * A + B, CLAIM_SENTINEL).to(cuda)
    want = tap.move_claims_ref(tcell)
    assert int((want[0] > 0).sum()) > 0 or A < 20
    for split in tpr.SPLITS:
        for g, w in zip(tap._move_claims_launch(tcell, split), want):
            assert torch.equal(g, w), split
    before = ops.launch_counts()["move_claims"]
    for g, w in zip(tap.move_claims(tcell), want):
        assert torch.equal(g, w)
    assert ops.launch_counts()["move_claims"] == before + 1


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("N", [1, 7, 8, 31, 32, 33, 1000])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("vh,vw", [(13, 13), (13, 12), (3, 3)])
def test_window_gather_ragged_bit_exact_on_card(cuda, N, dtype, vh, vw):
    """window_gather at ragged agent counts, with odd (13 x 91) and even
    (13 x 84) windows and a 3 x 21 one, narrower than a lane's stride
    through a warp tile (the kernel's stepping path), over a signed image
    (masked-off values are -0.0 where it is negative), a mask with zeros,
    positions on the image's edges and outside it: inside windows equal
    the plain version bit for bit, sign bits included; outside windows
    are +0.0.  In the split gather_split picks and in three others (blocks
    of 1, 5 and 37 warp tiles, which end inside windows)."""
    out_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    C, B = 7, 3
    Hp, Wp, lanes, _, _ = twg.padded_geometry(40, 40, C, vh, vw)
    vwc = vw * C
    g = torch.Generator(device="cpu").manual_seed(N * vw + vh)
    img = torch.randn((B, Hp, lanes), generator=g).to(cuda)
    ys = torch.randint(0, Hp - vh + 1, (B, N), generator=g)
    xs = torch.randint(0, (lanes - vwc) // C + 1, (B, N), generator=g)
    ys[:, 0], xs[:, 0] = Hp - vh, (lanes - vwc) // C  # the far edges
    if N > 1:
        ys[:, 1], xs[:, 1] = 0, 0
    pos = ys * Wp + xs
    out = torch.zeros((B, N), dtype=torch.bool)
    if N > 2:  # below the image, right of it, negative
        pos[0, 2] = (Hp - vh + 1) * Wp
        pos[1, 2] = 5 * Wp + (lanes - vwc) // C + 1
        pos[2, 2] = -1
        out[:, 2] = True
    mask = (torch.rand((vh, vwc), generator=g) < 0.7).float().to(cuda)
    kw = dict(vh=vh, vw=vw, C=C, Wp=Wp, out_dtype=out_dtype)
    inside = torch.where(out, 0, pos).to(torch.int32).to(cuda)
    pos = pos.to(torch.int32).to(cuda)
    out = out.to(cuda)
    picked = twg.gather_split(B, N, vh * vwc, out_dtype, torch.cuda.
                              get_device_properties(cuda).multi_processor_count)
    want = _bits(twg.window_gather_ref(img, inside, mask, **kw))
    assert bool((want == torch.iinfo(want.dtype).min).any())  # -0.0 values
    for per in (picked, 32, 160, 1184):
        got = _bits(twg._gather_launch(img, pos, mask, **kw, per=per))
        assert torch.equal(got[~out], want[~out]), per
        assert bool((got[out] == 0).all()), per
    before = ops.launch_counts()
    twg.window_gather(img, pos, mask, **kw)
    name = "window_gather" + ("_bf16" if dtype == "bf16" else "")
    assert ops.launch_counts()[name] == before[name] + 1


def test_lockstep_loop_gpu_matches_cpu(cuda):
    cfg = battle.get_config(24)
    envs = [VecGridWorld(cfg, [40, 40], 2, device=d) for d in (cuda, "cpu")]
    states = [e.reset(trandom.PRNGKey(3)) for e in envs]
    key = trandom.PRNGKey(4)
    for _ in range(3):
        keys = trandom.split(key)
        key, akey = keys[0], keys[1]
        obs = [e.observe_all(s) for e, s in zip(envs, states)]
        for (gv, gf), (cv, cf) in zip(*obs):
            torch.testing.assert_close(gv.cpu(), cv, atol=1e-6, rtol=0)
            assert torch.equal(gf.cpu(), cf)
        acts = [e.random_actions(akey) for e in envs]
        states = [e.transition(s, a)[0] for e, s, a in zip(envs, states, acts)]
        for name in FIELDS:
            assert torch.equal(getattr(states[0], name).cpu(),
                               getattr(states[1], name)), name


def _pursuit_operands(cuda, walls):
    """One recorded step of pursuit map 64, B=16 (train_evidence's
    placements): the operands of every rect kernel and window_gather4 call,
    recorded from the CPU run, moved to the card."""
    from magent_tpu_torch.builtin.config import pursuit

    placements, wall_cells = pursuit.layout(64, wall_frac=0.03 if walls else 0)
    venv = VecGridWorld(pursuit.get_config(64), [51, 102], 16,
                        placements=placements, walls=wall_cells or None,
                        device="cpu")
    calls = {"occupant_rect": [], "rect_first_overlap": [],
             "window_gather4": []}
    originals = {}
    for mod, name in ((tap, "occupant_rect"), (tap, "rect_first_overlap"),
                      (twg, "window_gather4")):
        fn = originals[name] = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name, **kwargs):
            calls[_name].append(([a.to(cuda) for a in args], {
                k: v.to(cuda) if isinstance(v, torch.Tensor) else v
                for k, v in kwargs.items()}))
            return _fn(*args, **kwargs)
        setattr(mod, name, rec)
    try:
        state = venv.reset(trandom.PRNGKey(0))
        venv.observe_all(state)
        venv.transition(state, venv.random_actions(trandom.PRNGKey(1)))
    finally:
        for mod, name in ((tap, "occupant_rect"), (tap, "rect_first_overlap"),
                          (twg, "window_gather4")):
            setattr(mod, name, originals[name])
    return calls


@pytest.mark.parametrize("walls", [False, True])
def test_rect_kernels_match_plain_on_card(cuda, walls):
    """occupant_rect (with and without exclude_self) and rect_first_overlap
    (both gates, as the step calls them) at the pursuit map-64 shapes: ints
    exact, hp exact (one body per cell)."""
    calls = _pursuit_operands(cuda, walls)
    assert len(calls["rect_first_overlap"]) == 2
    before = ops.launch_counts()
    (args, kw), = calls["occupant_rect"]
    for excl in (False, True):
        got = tap.occupant_rect(*args, exclude_self=excl)
        want = tap.occupant_rect_ref(*args, exclude_self=excl)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for args, kw in calls["rect_first_overlap"]:
        assert torch.equal(tap.rect_first_overlap(*args, **kw),
                           tap.rect_first_overlap_ref(*args, **kw))
    after = ops.launch_counts()
    assert after["occupant_rect"] == before["occupant_rect"] + 2
    assert after["rect_first_overlap"] == before["rect_first_overlap"] + 2


def _rect_calls(A, B, seed):
    """Both forms of each rect sweep on tools/profile_rect.py's ragged
    random operands: (wrapper, plain version, operands, keywords)."""
    occ, excl, low = tpr.ragged_operands(A, B, seed)
    return ([(tap.occupant_rect, tap.occupant_rect_ref, occ,
              dict(exclude_self=es)) for es in (False, True)]
            + [(tap.rect_first_overlap, tap.rect_first_overlap_ref, args,
                dict(max_body=2, gate=gate))
               for gate, args in (("exclude_self", excl),
                                  ("lower_only", low))])


def _assert_rect_equal(fn, ref, args, kw, cuda):
    args = [a.to(cuda) for a in args]
    got, want = fn(*args, **kw), ref(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), kw


@pytest.mark.parametrize("A", tpr.RAGGED_A)
def test_rect_kernels_match_plain_on_ragged_operands(cuda, A):
    """occupant_rect (both exclude_self values) and rect_first_overlap
    (both gates) on random bodies at ragged sizes, B=16 up to A=1000, else
    one world: ints and hp exact, one launch per call.  At A=16384 the
    lower_only plain version materializes ~2 GB of int64 keys, which fits
    in the H100's 80 GB."""
    B = 16 if A <= 1000 else 1
    before = ops.launch_counts()
    for fn, ref, args, kw in _rect_calls(A, B, A):
        _assert_rect_equal(fn, ref, args, kw, cuda)
    after = ops.launch_counts()
    assert after["occupant_rect"] == before["occupant_rect"] + 2
    assert after["rect_first_overlap"] == before["rect_first_overlap"] + 2


@pytest.mark.parametrize("case", ["ties", "last"])
@pytest.mark.parametrize("A", tpr.RAGGED_A)
def test_rect_kernels_match_plain_on_adversarial_operands(cuda, case, A):
    """Every query identical (keys tie and the slot decides), and the one
    body at the last slot of the last range of the last tile: both forms
    of each kernel exact."""
    B = 16 if A <= 1000 else 1
    for lower in (False, True):
        if case == "last" and lower and A < 2:
            continue
        occ, rect = tpr.adversarial_operands(A, B, case, lower)
        _assert_rect_equal(tap.occupant_rect, tap.occupant_rect_ref, occ,
                           dict(exclude_self=lower), cuda)
        _assert_rect_equal(tap.rect_first_overlap, tap.rect_first_overlap_ref,
                           rect, dict(max_body=2, gate="lower_only" if lower
                                      else "exclude_self"), cuda)


@pytest.mark.parametrize("A,B", [(153, 16), (1000, 2), (9375, 1)])
def test_rect_kernels_match_plain_in_every_split(cuda, A, B):
    """Every launch split (cluster of 1-8 CTAs, 1-8 warps each), not only
    the one rect_split picks, equals the plain version."""
    for fn, ref, args, kw in _rect_calls(A, B, 7 * A):
        args = [a.to(cuda) for a in args]
        name = fn.__name__
        want = ref(*args, **kw)
        want = want if isinstance(want, tuple) else (want,)
        for split in tpr.SPLITS:
            got = tpr.launch(name, args, kw, split)
            got = got if isinstance(got, tuple) else (got,)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (kw, split)


def test_window_gather4_matches_plain_on_card(cuda):
    """window_gather4 at the pursuit map-64 shapes in its three forms: no
    epilogue, liveness, and minimap + self mark + liveness: exact."""
    calls = _pursuit_operands(cuda, False)
    g = torch.Generator(device="cpu").manual_seed(0)
    before = ops.launch_counts()["window_gather4"]
    for (img, pos, mask), kw in calls["window_gather4"]:
        vh, vw, C = kw["vh"], kw["vw"], kw["C"]
        ch = torch.zeros(C)
        ch[[2, C - 1]] = 1.0
        mm_mask = ch.repeat(vh, vw)
        mm = dict(mm_img=(torch.rand((16, vh, vw * C), generator=g)
                          * mm_mask).to(cuda), mm_mask=mm_mask.to(cuda))
        self_cell = torch.randint(0, vh * vw, tuple(pos.shape), generator=g,
                                  dtype=torch.int32).to(cuda)
        geo = {k: kw[k] for k in ("vh", "vw", "C", "Wp")}
        for p, extra in ((pos, {}), (pos, {"act": kw["act"]}),
                         (pos + self_cell, dict(mm, act=kw["act"]))):
            got = twg.window_gather4(img, p, mask, **extra, **geo)
            assert torch.equal(got, twg.window_gather4_ref(img, p, mask,
                                                           **extra, **geo))
    assert ops.launch_counts()["window_gather4"] == before + 6


@pytest.mark.parametrize("walls", [False, True])
def test_pursuit_lockstep_gpu_matches_cpu(cuda, walls):
    """Pursuit map 32, B=2 (with 3% interior walls or without): the GPU run
    equals the CPU run, views exactly."""
    from magent_tpu_torch.builtin.config import pursuit

    placements, wall_cells = pursuit.layout(32, seed=3,
                                            wall_frac=0.03 if walls else 0)
    envs = [VecGridWorld(pursuit.get_config(32), [12, 25], 2,
                         placements=placements, walls=wall_cells or None,
                         device=d) for d in (cuda, "cpu")]
    states = [e.reset(trandom.PRNGKey(3)) for e in envs]
    key = trandom.PRNGKey(4)
    for _ in range(3):
        keys = trandom.split(key)
        key, akey = keys[0], keys[1]
        obs = [e.observe_all(s) for e, s in zip(envs, states)]
        for (gv, gf), (cv, cf) in zip(*obs):
            assert torch.equal(gv.cpu(), cv) and torch.equal(gf.cpu(), cf)
        acts = [e.random_actions(akey) for e in envs]
        states = [e.transition(s, a)[0] for e, s, a in zip(envs, states, acts)]
        for name in FIELDS:
            assert torch.equal(getattr(states[0], name).cpu(),
                               getattr(states[1], name)), name


@pytest.mark.parametrize("case", CASES)
def test_seg_kernels_match_plain_on_random_operands(cuda, case):
    """The three segmented sweeps' CUDA kernels on the random operands of
    tests/test_torch_port_seg_kernels.py (random hp and damage, possibly
    overlapping rects, slot ids shuffled by the sort; the degenerate case
    takes the overflow branch) against their plain versions: ints exact,
    occupant hp within 1e-6 (a query may sum several hp), rank sums within
    PAIR_ATOL; the compared floats are not all zero."""
    for name, fn, ref, args, kw in seg_calls(case):
        args = [a.to(cuda) for a in args]
        got, want = fn(*args, **kw), ref(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.dtype.is_floating_point:
                torch.testing.assert_close(g, w, rtol=0, atol=(
                    PAIR_ATOL if name == "rank_prefix_seg" else 1e-6))
                assert bool((w != 0).any()), name
            else:
                assert torch.equal(g, w), name


SEG_KERNELS = ("occupant_rect_seg", "rect_first_overlap_seg",
               "rank_prefix_seg", "window_gather_banded")


def _seg_world(device, walls=False):
    """Pursuit on one world at map 250 (seed 5) on the segmented route,
    observed through the banded gather (image budget 1 byte)."""
    from magent_tpu_torch.builtin.config import pursuit
    from magent_tpu_torch.core import engine, observe

    placements, wall_cells = pursuit.layout(250, 5, 0.03 if walls else 0)
    budget = observe.VMEM_IMAGE_BUDGET
    observe.VMEM_IMAGE_BUDGET = 1
    try:
        venv = VecGridWorld(pursuit.get_config(250),
                            [len(p) for p in placements], 1,
                            placements=placements, walls=wall_cells or None,
                            device=device)
    finally:
        observe.VMEM_IMAGE_BUDGET = budget
    wall_ctx = None
    if wall_cells:
        from magent_tpu_torch.parallel.vec_env import _wall_map
        wall_ctx = engine._wall_rect_code(
            venv.spec, _wall_map(venv.spec, wall_cells))
    venv._step = engine._build_step(
        venv.spec, engine._Route(grid=False, quad=True, seg=True), wall_ctx)
    return venv


def _on(v, device):
    """``v`` on ``device``: a tensor, or a tuple (a plan) of tensors and
    ints."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, tuple):
        return tuple(_on(x, device) for x in v)
    return v


def _valued_seg_forms(name, args, kw, gen):
    """The forms of one recorded seg-sweep call that the card checks:
    pursuit deals no damage and its hp is 1 everywhere, so the occupant
    gets random hp and the rank sweep random damage on its valid rows
    (targets below A), and the rank sweep also runs with every run of 4
    sorted rows sharing a target, so that its sums are not all zero; each
    as the step planned it and with the window forced below a segment
    (seg_win=512), which takes the full sweep -> [(args, kw, nonzero)],
    ``nonzero``: the float results must not all be zero."""
    def uniform(n):
        return (0.1 + 0.9 * torch.rand(n, generator=gen)).to(args[0].device)

    A = args[0].shape[0]
    forms = [(args, False)]
    if name == "occupant_rect_seg":
        forms = [(args[:6] + [uniform(A)] + args[7:], True)]
    elif name == "rank_prefix_seg":
        tgt, rank, _, sort_y = args
        forms = [([tgt, rank, torch.where(tgt < A, uniform(A), 0.0), sort_y],
                  False),
                 ([(torch.arange(A, device=tgt.device) // 4).to(torch.int32),
                   rank, uniform(A), sort_y], True)]
    narrow = {k: v for k, v in kw.items() if k != "plan"}
    return [(a, k, nz) for a, nz in forms
            for k in (kw, dict(narrow, seg_win=512))]


_SEG_MODS = {name: twg if name == "window_gather_banded" else tap
             for name in SEG_KERNELS}


def _seg_world_calls(cuda):
    """{name: [(args, kwargs)]} of the segmented sweeps' and the banded
    gather's calls in one step of :func:`_seg_world` on the CPU, moved to
    the card."""
    venv = _seg_world("cpu")
    calls = {name: [] for name in SEG_KERNELS}
    mods = _SEG_MODS
    originals = {name: getattr(mods[name], name) for name in SEG_KERNELS}
    for name, fn in originals.items():
        def rec(*args, _fn=fn, _name=name, **kwargs):
            calls[_name].append(([a.to(cuda) for a in args],
                                 {k: _on(v, cuda) for k, v in kwargs.items()}))
            return _fn(*args, **kwargs)
        setattr(mods[name], name, rec)
    try:
        state = venv.reset(trandom.PRNGKey(0))
        venv.observe_all(state)
        venv.transition(state, venv.random_actions(trandom.PRNGKey(1)))
    finally:
        for name, fn in originals.items():
            setattr(mods[name], name, fn)
    assert [len(calls[n]) for n in SEG_KERNELS] == [1, 2, 1, 2]
    return calls


def test_seg_kernels_match_plain_on_card(cuda):
    """The three segmented sweeps and the banded gather on one map-250 step's
    operands (recorded from the CPU run), as the step calls them and with
    the window forced below a segment (seg_win=512), which takes the full
    sweep, the occupant with random hp and the rank sweep with random
    damage (see :func:`_valued_seg_forms`): ints, windows and occupant hp
    exact, rank sums within PAIR_ATOL."""
    calls = _seg_world_calls(cuda)
    mods = _SEG_MODS
    gen = torch.Generator(device="cpu").manual_seed(0)
    before = ops.launch_counts()
    for name in SEG_KERNELS:
        kernel = getattr(mods[name], name)
        plain = getattr(mods[name], name + "_ref")
        for args, kw in calls[name]:
            forms = [(args, kw, False)] if name == "window_gather_banded" \
                else _valued_seg_forms(name, args, kw, gen)
            for a, k, nonzero in forms:
                got, want = kernel(*a, **k), plain(*a, **k)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for g, w in zip(got, want):
                    if name == "rank_prefix_seg":
                        torch.testing.assert_close(g, w, atol=PAIR_ATOL,
                                                   rtol=0)
                    else:
                        assert torch.equal(g, w), name
                    if nonzero and w.dtype.is_floating_point:
                        assert bool((w != 0).any()), name
    after = ops.launch_counts()
    assert [after[n] - before[n] for n in SEG_KERNELS] == [2, 4, 4, 2]


def _seg_splits(name, args, kw):
    """Every split of tools/profile_rect.py's table, then the one the
    wrapper picks for the window of the plan this call runs on (an
    overflow form sweeps every row with the same split)."""
    sort_y = args[-1] if name == "rank_prefix_seg" else args[-2]
    _, P, _, _ = kw.get("plan") or tap._seg_plan(sort_y, kw["margin"],
                                                 kw.get("seg_win"))
    return tpr.SPLITS + [tap.seg_split(args[0].shape[0], P,
                                       tap._build.sm_count(args[0].device))]


def _match_counts(args):
    """Per query of an occupant_rect_seg call: the bodies whose rect holds
    its cell."""
    qx, qy, x, y, bw, bh = args[:6]
    return ((qx[None, :] >= x[:, None]) & (qx[None, :] < (x + bw)[:, None])
            & (qy[None, :] >= y[:, None])
            & (qy[None, :] < (y + bh)[:, None])).sum(0)


def _assert_seg_split_equal(name, args, kw, integer, nonzero):
    """``name`` (occupant_rect_seg or rank_prefix_seg) in every split of
    :func:`_seg_splits` against its plain version: slot ids exact;
    occupant hp bit for bit on every query with at most two matches (a + b
    = b + a), within 1e-6 on piles of three or more (the sum runs in
    window order); rank sums exact on ``integer`` damages, else within
    PAIR_ATOL; with ``nonzero``, the plain version's floats are not all
    zero."""
    if name == "occupant_rect_seg":
        want = tap.occupant_rect_seg_ref(*args, **kw)
        few = _match_counts(args) <= 2
    else:
        want = tap.rank_prefix_seg_ref(*args, **kw)
    for split in _seg_splits(name, args, kw):
        got = tpr.launch(name, args, kw, split)
        if name == "occupant_rect_seg":
            assert torch.equal(got[0], want[0]), split
            assert torch.equal(got[1][few], want[1][few]), split
            torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=0)
        elif integer:
            assert torch.equal(got, want), split
        else:
            torch.testing.assert_close(got, want, atol=PAIR_ATOL, rtol=0)
    floats = want[1] if name == "occupant_rect_seg" else want
    assert not nonzero or bool((floats != 0).any()), name


def _without_plan(kw, seg_win):
    return dict({n: v for n, v in kw.items() if n != "plan"}, seg_win=seg_win)


@pytest.mark.parametrize("case", CASES)
def test_seg_split_kernels_match_plain_on_random_operands(cuda, case):
    """occupant_rect_seg and rank_prefix_seg on the random operands of
    tests/_torch_seg_operands.py (possibly overlapping rects, slot ids
    shuffled by the sort, random hp and damage; the degenerate case
    overflows), as planned and with the window forced below a segment
    (seg_win=512), in every split: see :func:`_assert_seg_split_equal`;
    the rank sweep also on the same ranks with integer damages, exact;
    the entry points launch their kernels once per call."""
    for name, fn, _, args, kw in seg_calls(case):
        if name not in tpr.SEG_SPLIT_SWEEPS:
            continue
        args = [a.to(cuda) for a in args]
        for k in (kw, _without_plan(kw, 512)):
            _assert_seg_split_equal(name, args, k, False, True)
            if name == "rank_prefix_seg":
                tgt, rank, dmg, sort_y = args
                whole = torch.where(dmg > 0, torch.ceil(3 * dmg), 0.0)
                _assert_seg_split_equal(name, [tgt, rank, whole, sort_y], k,
                                        True, True)
        before = ops.launch_counts()[name]
        fn(*args, **kw)
        assert ops.launch_counts()[name] == before + 1


def test_seg_split_kernels_match_plain_on_card(cuda):
    """occupant_rect_seg and rank_prefix_seg on one map-250 step's operands
    in every split, as the step planned them and with seg_win=512 (the
    full sweep): the occupant with random hp (exact: the step's bodies
    never overlap), the rank sweep with random damage (within PAIR_ATOL),
    and with each run of 4 sorted rows sharing a target and integer
    damages 1-3 (exact)."""
    calls = _seg_world_calls(cuda)
    gen = torch.Generator(device="cpu").manual_seed(1)
    for name in tpr.SEG_SPLIT_SWEEPS:
        (args, kw), = calls[name]
        forms = [(a, k, False, nz) for a, k, nz in _valued_seg_forms(
            name, args, kw, gen)]
        if name == "rank_prefix_seg":
            tgt, rank, _, sort_y = args
            A = tgt.shape[0]
            whole = torch.randint(1, 4, (A,), generator=gen).float()
            shared = [(torch.arange(A, device=cuda) // 4).to(torch.int32),
                      rank, whole.to(cuda), sort_y]
            forms += [(shared, k, True, True)
                      for k in (kw, _without_plan(kw, 512))]
        else:
            assert int(_match_counts(args).max()) <= 1
        for a, k, integer, nonzero in forms:
            _assert_seg_split_equal(name, a, k, integer, nonzero)


@pytest.mark.parametrize("walls", [False, True])
def test_seg_world_gpu_matches_cpu(cuda, walls):
    """Pursuit map 250, one world on the segmented route and the banded
    gather: the GPU run equals the CPU run, views exactly."""
    envs = [_seg_world(d, walls) for d in (cuda, "cpu")]
    states = [e.reset(trandom.PRNGKey(3)) for e in envs]
    key = trandom.PRNGKey(4)
    for _ in range(3):
        keys = trandom.split(key)
        key, akey = keys[0], keys[1]
        obs = [e.observe_all(s) for e, s in zip(envs, states)]
        for (gv, gf), (cv, cf) in zip(*obs):
            assert torch.equal(gv.cpu(), cv) and torch.equal(gf.cpu(), cf)
        acts = [e.random_actions(akey) for e in envs]
        states = [e.transition(s, a)[0] for e, s, a in zip(envs, states, acts)]
        for name in FIELDS:
            assert torch.equal(getattr(states[0], name).cpu(),
                               getattr(states[1], name)), name


def test_window_ladder_matches_plain_on_card(cuda):
    """Every ladder level and shared_tile equal their plain versions
    exactly, and ladder(mask) equals window_gather4, at N=450 with chunks
    of 40 (blocks cut at chunk boundaries, a ragged last chunk), 200 and
    past N."""
    inp = tpw.make_inputs(3, B=3, N=450, device=cuda)
    g, pos, mask = inp["gfull"], inp["pos"], inp["mask"]
    geo = tpw.geometry(inp)
    before = ops.launch_counts()
    for chunk in (40, 200, 1000):
        for level in twl.LEVELS:
            got = twl.ladder(g, pos, mask, level=level, chunk=chunk, **geo)
            want = twl.ladder_ref(g, pos, mask, level=level, chunk=chunk,
                                  **geo)
            assert torch.equal(got, want), level
        assert torch.equal(got, twg.window_gather4(g, pos * 1024, mask, **geo))
        got = twl.shared_tile(g, pos, mask, chunk=chunk, **geo)
        want = twl.shared_tile_ref(g, pos, mask, chunk=chunk, **geo)
        assert torch.equal(got, want), chunk
    after = ops.launch_counts()
    assert after["window_ladder"] == before["window_ladder"] + 18
    assert after["window_shared_tile"] == before["window_shared_tile"] + 3


BF16 = torch.bfloat16


def test_bf16_window_kernels_match_plain_on_card(cuda):
    """The bf16 store of each window kernel equals its plain version (f32
    math, ``.to(bf16)`` last) exactly, and counts under its own name:
    window_gather on battle's 13x91 windows, window_gather4 in its three
    forms at pursuit map 64, window_gather_banded on a map-90 image."""
    spec = VecGridWorld(battle.get_config(40), [30, 30], 1, device="cpu").spec
    C = spec.n_channel
    vr = spec.groups[0].type.view_range
    Hp, Wp, lanes, pad_y, pad_x = twg.padded_geometry(40, 40, C, vr.height,
                                                      vr.width)
    g = torch.Generator(device="cpu").manual_seed(1)
    img = torch.rand((3, Hp, lanes), generator=g).to(cuda)
    xs = torch.randint(0, 40, (3, 70), generator=g) + vr.x1 + pad_x
    ys = torch.randint(0, 40, (3, 70), generator=g) + vr.y1 + pad_y
    pos = (ys * Wp + xs).to(torch.int32).to(cuda)
    mask = torch.as_tensor(np.repeat(vr.mask.astype(np.float32), C, axis=1),
                           device=cuda)
    kw = dict(vh=vr.height, vw=vr.width, C=C, Wp=Wp, out_dtype=BF16)
    before = ops.launch_counts()
    got = twg.window_gather(img, pos, mask, **kw)
    assert got.dtype == BF16
    assert torch.equal(got, twg.window_gather_ref(img, pos, mask, **kw))
    band = dict(kw, chunk=40, band_rows=32)
    got = twg.window_gather_banded(img, pos, mask, **band, unsort=False)
    want = twg.window_gather_banded_ref(img, pos, mask, **band, unsort=False)
    assert got[0].dtype == BF16
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(twg.window_gather_banded(img, pos, mask, **band),
                       twg.window_gather_banded_ref(img, pos, mask, **band))
    for (img4, pos4, mask4), k in _pursuit_operands(cuda, False)[
            "window_gather4"]:
        geo = {n: k[n] for n in ("vh", "vw", "C", "Wp")}
        vh, vw, C4 = geo["vh"], geo["vw"], geo["C"]
        ch = torch.zeros(C4)
        ch[[2, C4 - 1]] = 1.0
        mm_mask = ch.repeat(vh, vw)
        mm = dict(mm_img=(torch.rand((16, vh, vw * C4), generator=g)
                          * mm_mask).to(cuda), mm_mask=mm_mask.to(cuda))
        for extra in ({}, {"act": k["act"]}, dict(mm, act=k["act"])):
            got = twg.window_gather4(img4, pos4, mask4, **extra, **geo,
                                     out_dtype=BF16)
            assert torch.equal(got, twg.window_gather4_ref(
                img4, pos4, mask4, **extra, **geo, out_dtype=BF16))
    after = ops.launch_counts()
    assert [after[n] - before[n] for n in (
        "window_gather_bf16", "window_gather_banded_bf16",
        "window_gather4_bf16", "window_gather", "window_gather4")] == [
        1, 2, 6, 0, 0]


@pytest.mark.parametrize("case", ["battle", "pursuit"])
def test_bf16_views_are_f32_views_rounded_on_card(cuda, case):
    """``make_observe(..., obs_dtype=bf16)`` on the card: the f32 views
    rounded, features unchanged (battle: the roll route, pursuit map 64:
    window_gather4)."""
    if case == "battle":
        venv = VecGridWorld(battle.get_config(40), [60, 60], 2, device=cuda)
    else:
        from magent_tpu_torch.builtin.config import pursuit

        placements, _ = pursuit.layout(64)
        venv = VecGridWorld(pursuit.get_config(64), [51, 102], 4,
                            placements=placements, device=cuda)
    state = venv.reset(trandom.PRNGKey(5))
    grids = venv._grids(state)
    for grp in range(venv.spec.n_groups):
        v32, f32 = venv.observe(state, grp, grids)
        v16, f16 = tobserve.make_observe(venv.spec, grp, obs_dtype=BF16)(
            state, grids)
        assert v16.dtype == BF16 and torch.equal(v16, v32.to(BF16))
        assert torch.equal(f16, f32)


TRUSTY = ["data/models/trusty-battle-game-%s/tfdqn_0.npz" % s for s in "lr"]


def _trusty_nets(spec, device):
    nets = []
    for g, path in enumerate(TRUSTY):
        net = DQNNet(spec.view_space(g), spec.feature_size(g),
                     spec.groups[g].type.n_action)
        net.load_state_dict(params_from_flax(dict(np.load(path))))
        nets.append(net.to(device))
    return tuple(nets)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_gpu_matches_cpu(cuda, remat):
    """One fused DQN step (minibatch 32, or remat with two sampled steps)
    at battle map 20, [6, 6], B=4, rollout 3, eps 1.0, f32 with cuDNN's
    TF32 off: the rollouts and end states equal; losses within rtol 1e-5,
    the Adam moments and parameters by ``assert_adam_steps_close``'s rule:
    moments within 1e-2 of each tensor's largest (a ReLU whose input lies
    within rounding of 0 opens on one device and not the other and passes
    a sample's whole gradient: conv1's moments lie 3e-3 of their largest
    apart at this size), parameters within 2e-5 where the gradient's sign
    is settled."""
    out = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for d in (cuda, torch.device("cpu")):
            venv = VecGridWorld(battle.get_config(20), [6, 6], 4, device=d)
            tx = ClipAdam(1e-4, 5.0)
            step = (make_dqn_train_step_remat(venv, tx, rollout_len=3,
                                              sample_steps=2) if remat else
                    make_dqn_train_step(venv, tx, rollout_len=3,
                                        train_minibatch=32))
            nets = _trusty_nets(venv.spec, d)
            state = venv.reset(trandom.PRNGKey(0).to(d))
            _, traj = step.rollout(nets, state, trandom.PRNGKey(1).to(d), 1.0)
            nets, opts, state, m = step(nets, _trusty_nets(venv.spec, d),
                                        tuple(tx.init(n) for n in nets),
                                        state, trandom.PRNGKey(2).to(d), 1.0)
            out[d.type] = (traj, state, m, step_flat(nets, opts))
    (gt, gs, gm, gf), (ct, cs, cm, cf) = out["cuda"], out["cpu"]
    for name in ("actions", "rewards", "alive", "alive_in", "done"):
        assert torch.equal(gt[name].cpu(), ct[name]), name
    for name in FIELDS:
        assert torch.equal(getattr(gs, name).cpu(), getattr(cs, name)), name
    torch.testing.assert_close(gm["loss"].cpu(), cm["loss"], rtol=1e-5,
                               atol=0)
    for g, ((gp, gmom), (cp, cmom)) in enumerate(zip(gf, cf)):
        assert_adam_steps_close(gp, cp, gmom, cmom, lr=1e-4, moment_rtol=1e-2,
                                param_atol=2e-5, tag="group %d" % g)


def _fresh(cls, spec, device, **kw):
    return tuple(cls(spec.view_space(g), spec.feature_size(g),
                     spec.groups[g].type.n_action,
                     generator=torch.Generator().manual_seed(16 + g),
                     **kw).to(device) for g in range(spec.n_groups))


def _a2c_gaps(venv, nets, traj, rkey):
    """Top-two ``log(policy) + gumbel`` gaps of an A2C rollout's draws
    (parallel/train.py's key walk); each draw took its top score."""
    key, gaps = rkey, []
    with torch.no_grad():
        for t in range(traj["actions"].shape[0]):
            key, akey = trandom.split(key).unbind(-2)
            for g, gs in enumerate(venv.spec.groups):
                sl = slice(gs.offset, gs.offset + gs.cap)
                pol, _ = nets[g](traj["views"][g][t], traj["feats"][g][t],
                                 traj["alive_in"][t][:, sl].float())
                scores = (trandom.gumbel(trandom.fold_in(akey, g), pol.shape)
                          + pol.log())
                assert torch.equal(scores.argmax(-1).int(),
                                   traj["actions"][t][:, sl])
                top2 = scores.topk(2, -1).values
                gaps.append((top2[..., 0] - top2[..., 1]).flatten())
    return torch.cat(gaps)


# the A2C and DRQN trainers' forms: (trainer, keywords); A2C's go to its
# nets, DRQN's to make_drqn_train_step
TRAINER_FORMS = {
    "a2c": ("a2c", {}),
    "a2c-comm": ("a2c", dict(use_comm=True)),
    "drqn": ("drqn", dict(share_acting=True, unroll_remat="all")),
    "drqn-share-none": ("drqn", dict(share_acting=True, unroll_remat=False)),
    "drqn-share-dots": ("drqn", dict(share_acting=True, unroll_remat="dots")),
    "drqn-noshare-none": ("drqn", dict(share_acting=False,
                                       unroll_remat=False)),
    "drqn-noshare-dots": ("drqn", dict(share_acting=False,
                                       unroll_remat="dots")),
    "drqn-noshare-all": ("drqn", dict(share_acting=False,
                                      unroll_remat="all")),
}


def _trainer_step(form, d):
    """One step of trainer form ``form`` on device ``d`` at the size below
    -> (rollout, end state, metrics, step_flat, hiddens or A2C's gaps)."""
    from magent_tpu_torch.builtin.torch_model import A2CNet, DRQNNet
    from magent_tpu_torch.parallel import (init_drqn_hiddens,
                                           make_a2c_train_step,
                                           make_drqn_train_step)

    alg, kw = TRAINER_FORMS[form]
    venv = VecGridWorld(battle.get_config(20), [6, 6], 4, device=d)
    tx = ClipAdam(1e-4, 5.0)
    state = venv.reset(trandom.PRNGKey(0).to(d))
    key = trandom.PRNGKey(2).to(d)
    rkey = trandom.split(key)[1]
    if alg == "a2c":
        step = make_a2c_train_step(venv, tx, rollout_len=3)
        nets = _fresh(A2CNet, venv.spec, d, **kw)
        _, traj = step.rollout(nets, state, rkey)
        extra = _a2c_gaps(venv, nets, traj, rkey)
        nets, opts, state, m = step(
            nets, tuple(tx.init(n) for n in nets), state, key)
    else:
        step = make_drqn_train_step(venv, tx, rollout_len=3, **kw)
        nets = _fresh(DRQNNet, venv.spec, d)
        h0 = init_drqn_hiddens(venv, nets)
        with torch.no_grad():
            _, _, traj = step.rollout(nets, state, h0, rkey, 1.0)
        nets, opts, state, extra, m = step(
            nets, _fresh(DRQNNet, venv.spec, d),
            tuple(tx.init(n) for n in nets), state, h0, key, 1.0)
    return traj, state, m, step_flat(nets, opts), extra


def _assert_same_step(a, b):
    """Two :func:`_trainer_step` results bit for bit."""
    (at, as_, am, af, ae), (bt, bs, bm, bf, be) = a, b
    for name in ("actions", "rewards", "alive", "alive_in", "done"):
        assert torch.equal(at[name], bt[name]), name
    for name in FIELDS:
        assert torch.equal(getattr(as_, name), getattr(bs, name)), name
    for name in am:
        assert torch.equal(am[name], bm[name]), name
    for x, y in zip(ae, be):
        assert torch.equal(x, y)
    for (ap_, amom), (bp, bmom) in zip(af, bf):
        for p, q in zip((ap_,) + amom, (bp,) + bmom):
            assert sorted(p) == sorted(q)
            for k in p:
                np.testing.assert_array_equal(p[k], q[k], err_msg=k)


@pytest.mark.parametrize("form", sorted(TRAINER_FORMS))
def test_a2c_drqn_step_gpu_matches_cpu(cuda, form):
    """One fused A2C step (fresh nets, without and with CommNet) and one
    DRQN step (fresh nets, eps 1.0; ``share_acting`` with ``unroll_remat``
    "all", False and "dots", and without it with False, "dots" and "all")
    at battle map 20, [6, 6], B=4, rollout 3, f32 with TF32 off: the
    rollouts and end states equal (A2C: every draw's top two scores on the
    CPU more than 1e-5 apart, so the equal draws are not luck); losses
    (A2C's mean values too) within rtol 1e-5; DRQN's hiddens within 1e-5;
    the Adam moments and parameters by ``test_train_step_gpu_matches_cpu``'s
    rule.  Two runs on the card, on cuDNN's default algorithm choice (the
    trainers' halves run under ``deterministic_convolutions``), equal bit
    for bit."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got, again, want = (_trainer_step(form, d)
                            for d in (cuda, cuda, torch.device("cpu")))
    _assert_same_step(got, again)
    (gt, gs, gm, gf, ge), (ct, cs, cm, cf, ce) = got, want
    for name in ("actions", "rewards", "alive", "alive_in", "done"):
        assert torch.equal(gt[name].cpu(), ct[name]), name
    for name in FIELDS:
        assert torch.equal(getattr(gs, name).cpu(), getattr(cs, name)), name
    for name in cm:
        torch.testing.assert_close(gm[name].cpu(), cm[name], rtol=1e-5,
                                   atol=0)
    if TRAINER_FORMS[form][0] == "a2c":
        assert float(ce.min()) > 1e-5
    else:
        for a, b in zip(ge, ce):
            assert a.grad_fn is None
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    for g, ((gp, gmom), (cp, cmom)) in enumerate(zip(gf, cf)):
        assert_adam_steps_close(gp, cp, gmom, cmom, lr=1e-4, moment_rtol=1e-2,
                                param_atol=2e-5, tag="group %d" % g)


# ------------------------------------------- the window kernel's other forms
WINDOW_DTYPES = {"f32": torch.float32, "bf16": BF16}
# an 11 x 55 window and pursuit's prey window, 9 x 45 (C = 5, the wide
# branch in either dtype), and a 3 x 15 one (E = 45: the stepping branch in
# f32 and bf16)
EPI_WINDOWS = [(11, 11), (9, 9), (3, 3)]
EPI_FORMS = ("none", "liveness", "minimap")


def _epi_case(cuda, B, N, vh, vw, packed, seed):
    """A signed image over pursuit's padded geometry at map 40 (C = 5),
    positions at random, on the far edges and (N > 2) outside the image
    (below it, right of it, negative), a mask with zeros, seeded liveness,
    pooled minimaps, minimap channels and self cells -> (img, pos, inside,
    outside, mask, epilogue operands, geometry)."""
    C = 5
    Hp, Wp, lanes, _, _ = twg.padded_geometry(40, 40, C, vh, vw)
    vwc = vw * C
    g = torch.Generator(device="cpu").manual_seed(seed)
    img = torch.randn((B, Hp, lanes), generator=g)
    ys = torch.randint(0, Hp - vh + 1, (B, N), generator=g)
    xs = torch.randint(0, (lanes - vwc) // C + 1, (B, N), generator=g)
    ys[:, 0], xs[:, 0] = Hp - vh, (lanes - vwc) // C
    pos = ys * Wp + xs
    out = torch.zeros((B, N), dtype=torch.bool)
    if N > 2:
        # below: the window's last row (packed), its first row (banded)
        pos[0, 2] = (Hp - vh + 1) * Wp if packed else Hp * Wp + 3
        pos[-1, 2] = 5 * Wp + (lanes - vwc) // C + 1
        pos[B // 2, N - 1] = -1
        out[0, 2] = out[-1, 2] = out[B // 2, N - 1] = True
    inside = torch.where(out, 0, pos)
    mask = (torch.rand((vh, vwc), generator=g) < 0.7).float()
    ch = torch.zeros(C)
    ch[[2, C - 1]] = 1.0
    epi = dict(act=(torch.rand((B, N), generator=g) < 0.8).to(torch.int32),
               mm=torch.rand((B, vh, vw, C), generator=g) * ch, mm_maskc=ch,
               self_cell=torch.randint(0, vh * vw, (B, N), generator=g,
                                       dtype=torch.int32))
    on = lambda t: t.to(cuda)  # noqa: E731
    return (on(img), on(pos.to(torch.int32)), on(inside.to(torch.int32)),
            on(out), on(mask), {k: on(v) for k, v in epi.items()},
            dict(vh=vh, vw=vw, C=C, Wp=Wp))


def _picks(cuda, B, N, E, out_dtype):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    return (twg.gather_split(B, N, E, out_dtype, sms), 32, 160, 1184)


def _where_out(out, got, want_in, want_out):
    """Slots outside the image take ``want_out``, the others ``want_in``;
    bitwise against ``got``."""
    want = torch.where(out[..., None, None], want_out, want_in)
    return torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("N", [1, 7, 33, 102, 300])
@pytest.mark.parametrize("dtype", sorted(WINDOW_DTYPES))
@pytest.mark.parametrize("form", EPI_FORMS)
@pytest.mark.parametrize("vh,vw", EPI_WINDOWS)
def test_window_gather4_ragged_bit_exact_on_card(cuda, N, dtype, form, vh,
                                                 vw):
    """window_gather4 in its three epilogue forms at ragged N, B in {1, 3,
    16} (spans cross agents and envs, each env with its own minimap),
    pursuit's windows and a narrow one, a signed image (-0.0 under zero
    mask entries), positions on the edges and outside the image: inside
    windows equal the plain version bit for bit, outside ones the plain
    epilogue of a zero window; in the split gather_split picks and in
    spans of 32, 160 and 1184 vectors."""
    out_dtype = WINDOW_DTYPES[dtype]
    for B in (1, 3, 16):
        img, pos, inside, out, mask, epi, geo = _epi_case(
            cuda, B, N, vh, vw, True, N * 31 + vh + B)
        C = geo["C"]
        self_cell = epi["self_cell"]
        ops4 = {}
        if form != "none":
            ops4["act"] = epi["act"]
        if form == "minimap":
            ops4.update(mm_img=epi["mm"].reshape(B, vh, vw * C),
                        mm_mask=epi["mm_maskc"].repeat(vh, vw))
        packed = lambda p: p * 1024 + self_cell  # noqa: E731
        kw = dict(geo, out_dtype=out_dtype)
        want_in = twg.window_gather4_ref(img, packed(inside), mask, **ops4,
                                         **kw)
        want_out = twg.window_gather4_ref(torch.zeros_like(img),
                                          packed(inside), mask, **ops4, **kw)
        for per in _picks(cuda, B, N, vh * vw * C, out_dtype):
            got = twg._gather4_launch(
                img, packed(pos), mask, ops4.get("mm_img"),
                ops4.get("mm_mask"), ops4.get("act"), **kw, per=per)
            assert _where_out(out, got, want_in, want_out), (B, per)
        before = ops.launch_counts()
        twg.window_gather4(img, packed(pos), mask, **ops4, **kw)
        name = "window_gather4" + ("_bf16" if dtype == "bf16" else "")
        assert ops.launch_counts()[name] == before[name] + 1


@pytest.mark.parametrize("N", [1, 7, 33, 102, 300])
@pytest.mark.parametrize("dtype", sorted(WINDOW_DTYPES))
@pytest.mark.parametrize("form", EPI_FORMS + ("band order",))
@pytest.mark.parametrize("vh,vw", EPI_WINDOWS)
def test_window_gather_banded_ragged_bit_exact_on_card(cuda, N, dtype, form,
                                                       vh, vw):
    """window_gather_banded in slot order with each epilogue form (bf16:
    rounded at the store and again after the epilogue) and in band order
    (dummy rows included), B in {1, 3, 16}, at ragged N, with windows
    reaching past the image's last row, and in slot order also windows at
    a negative position, below the image and leaving it on the right
    (whole-window zeros before the epilogue): bit for bit against the
    plain version; in the split gather_split picks and in spans of 32, 160
    and 1184 vectors."""
    out_dtype = WINDOW_DTYPES[dtype]
    band = dict(chunk=8, band_rows=16)
    for B in (1, 3, 16):
        img, pos, inside, out, mask, epi, geo = _epi_case(
            cuda, B, N, vh, vw, False, N * 37 + vh + B)
        Hp = img.shape[1]
        # the last window starts on the image's last rows: rows past Hp
        inside[:, 0] = (Hp - 2) * geo["Wp"]
        pos[:, 0] = inside[:, 0]
        kw = dict(geo, out_dtype=out_dtype)
        if form == "band order":
            got = twg.window_gather_banded(img, inside, mask, **kw, **band,
                                           unsort=False)
            want = twg.window_gather_banded_ref(img, inside, mask, **kw,
                                                **band, unsort=False)
            assert torch.equal(got[1], want[1])
            assert torch.equal(_bits(got[0]), _bits(want[0]))
            pos_pad = twg.banded_tables(
                inside, Wp=geo["Wp"], band_rows=16,
                n_bands=-(-Hp // 16), chunk=8)[0]
            for per in _picks(cuda, B, pos_pad.shape[1],
                              vh * vw * geo["C"], out_dtype):
                got = twg._banded_launch(img, pos_pad, mask, **kw, per=per)
                assert torch.equal(_bits(got), _bits(want[0])), (B, per)
            continue
        ops_b = {}
        if form != "none":
            ops_b["act"] = epi["act"]
        if form == "minimap":
            ops_b.update({k: epi[k] for k in ("mm", "self_cell",
                                              "mm_maskc")})
        want_in = twg.window_gather_banded_ref(img, inside, mask, **kw,
                                               **band, **ops_b)
        want_out = twg.window_gather_banded_ref(
            torch.zeros_like(img), inside, mask, **kw, **band, **ops_b)
        if form == "none":  # the rows past Hp
            assert bool((_bits(want_in)[:, 0, -1] == 0).all())
        for per in _picks(cuda, B, N, vh * vw * geo["C"], out_dtype):
            got = twg._banded_launch(img, pos, mask, **kw, per=per, **ops_b)
            assert _where_out(out, got, want_in, want_out), (B, per)
        before = ops.launch_counts()
        got = twg.window_gather_banded(img, pos, mask, **kw, **band, **ops_b)
        assert _where_out(out, got, want_in, want_out)
        name = "window_gather_banded" + ("_bf16" if dtype == "bf16" else "")
        assert ops.launch_counts()[name] == before[name] + 1


def test_battle_banded_bf16_gpu_matches_cpu(cuda):
    """Battle map 40, 2x60, B=2, bf16 views, forced onto the banded route
    (image budget 1 byte), minimap on: the card's views, features and
    states equal the CPU's over 3 steps, each step's views through one
    banded launch per group."""
    budget = tobserve.VMEM_IMAGE_BUDGET
    tobserve.VMEM_IMAGE_BUDGET = 1
    try:
        envs = [VecGridWorld(battle.get_config(40), [60, 60], 2,
                             obs_dtype=BF16, device=d) for d in (cuda, "cpu")]
    finally:
        tobserve.VMEM_IMAGE_BUDGET = budget
    assert envs[0].spec.minimap_mode
    assert [o.route for o in envs[0]._observe] == ["window_gather_banded"] * 2
    states = [e.reset(trandom.PRNGKey(7).to(d))
              for e, d in zip(envs, (cuda, "cpu"))]
    key = trandom.PRNGKey(8)
    for _ in range(3):
        keys = trandom.split(key)
        key, akey = keys[0], keys[1]
        before = ops.launch_counts()["window_gather_banded_bf16"]
        obs = [e.observe_all(s) for e, s in zip(envs, states)]
        assert ops.launch_counts()["window_gather_banded_bf16"] == before + 2
        for (gv, gf), (cv, cf) in zip(*obs):
            assert gv.dtype == BF16 and bool((cv != 0).any())
            assert torch.equal(_bits(gv.cpu()), _bits(cv))
            assert torch.equal(gf.cpu(), cf)
        acts = [e.random_actions(akey.to(d))
                for e, d in zip(envs, (cuda, "cpu"))]
        assert torch.equal(acts[0].cpu(), acts[1])
        states = [e.transition(s, a)[0]
                  for e, s, a in zip(envs, states, acts)]
        for name in FIELDS:
            assert torch.equal(getattr(states[0], name).cpu(),
                               getattr(states[1], name)), name


def _rule_config(values):
    """Rule shapes that reach every branch of the general join (an 'all'
    subject and its inferred object, a fixed-index subject, an 'any'
    subject's inferred object paid per slot, align, in_a_line, NOT / OR)
    and double_attack's pair rule, with receiver values ``values``."""
    from magent_tpu_torch import gridworld as gw

    cfg = gw.Config()
    cfg.set({"map_width": 16, "map_height": 16})
    t = cfg.register_agent_type("t", {"hp": 5, "view_range": gw.CircleRange(2),
                                      "attack_range": gw.CircleRange(1),
                                      "damage": 1})
    g0, g1 = cfg.add_group(t), cfg.add_group(t)
    a, a2 = gw.AgentSymbol(g0, "any"), gw.AgentSymbol(g0, "any")
    b, c = gw.AgentSymbol(g1, "any"), gw.AgentSymbol(g1, "any")
    all0, all1 = gw.AgentSymbol(g0, "all"), gw.AgentSymbol(g1, "all")
    first = gw.AgentSymbol(g0, 1)
    v = iter(values)
    cfg.add_reward_rule(gw.Event(a, "attack", b) & gw.Event(a, "align"),
                        receiver=[a, b], value=[next(v), next(v)])
    cfg.add_reward_rule(gw.Event(all0, "attack", c)
                        | gw.Event(c, "in", ((2, 2), (12, 12))),
                        receiver=[all0, c], value=[next(v), next(v)])
    cfg.add_reward_rule(gw.Event(first, "kill", c) & ~gw.Event(c, "die"),
                        receiver=[first, c], value=[next(v), next(v)])
    cfg.add_reward_rule(gw.Event(all1, "in_a_line"), receiver=all1,
                        value=next(v))
    cfg.add_reward_rule(gw.Event(a, "attack", c) & gw.Event(a2, "attack", c),
                        receiver=[a, a2, c], value=[next(v), next(v), next(v)])
    return cfg


def _rule_arrays(spec, seed, B, integer):
    """Random rule states: per-group live prefixes, ops on live slots,
    positions on a few rows and columns (align, in_a_line); rewards carried
    in, integer-valued when ``integer``."""
    from magent_tpu_torch.spec import OP_ATTACK, OP_COLLIDE, OP_KILL, OP_NULL

    rng = np.random.RandomState(seed)
    A, G, H, W = spec.n_agents_cap, spec.n_groups, spec.height, spec.width
    active = np.zeros((B, A), bool)
    for b in range(B):
        for g in spec.groups:
            n = rng.randint(g.cap // 2, g.cap + 1)
            active[b, g.offset:g.offset + n] = True
    last_op = rng.choice([OP_NULL, OP_ATTACK, OP_KILL, OP_COLLIDE], (B, A))
    live = [np.flatnonzero(active[b]) for b in range(B)]
    # a third of the ops on three targets: piles of attackers
    op_obj = np.stack([np.where(rng.uniform(size=A) < 0.3,
                                rng.choice(live[b][-3:], A),
                                rng.choice(live[b], A)) for b in range(B)])
    reward = rng.normal(size=(B, A)) * 3
    greward = rng.normal(size=(B, G)) * 3
    if integer:
        reward, greward = np.round(reward), np.round(greward)
    arrays = {
        "cell_slot": np.full((B, H, W), -1, np.int32),
        "cell_wall": np.zeros((B, H, W), bool),
        "cell_food": np.zeros((B, H, W), np.float32),
        "x": rng.randint(1, 5, (B, A)).astype(np.int32),
        "y": rng.randint(1, 5, (B, A)).astype(np.int32),
        "dir": np.zeros((B, A), np.int32),
        "hp": np.ones((B, A), np.float32),
        "active": active,
        "dead": (rng.uniform(size=(B, A)) < 0.1) & active,
        "absorbed": np.zeros((B, A), bool),
        "id": np.zeros((B, A), np.int32),
        "last_action": np.zeros((B, A), np.int32),
        "next_reward": reward.astype(np.float32),
        "last_reward": np.zeros((B, A), np.float32),
        "last_op": np.where(active, last_op, OP_NULL).astype(np.int32),
        "op_obj": np.where(active & (last_op != OP_NULL), op_obj,
                           -1).astype(np.int32),
        "group_reward": greward.astype(np.float32),
        "n_in_group": np.zeros((B, G), np.int32),
        "lcg": np.ones(B, np.uint32),
        "key": np.zeros((B, 2), np.uint32),
        "done": np.zeros(B, bool),
        "id_counter": np.full(B, A, np.int32),
        "step_ct": np.zeros(B, np.int32),
    }
    # group 1 stands in one column of contiguous rows in env 0 (in_a_line)
    g1 = spec.groups[1]
    arrays["x"][0, g1.offset:g1.offset + g1.cap] = 7
    arrays["y"][0, g1.offset:g1.offset + g1.cap] = np.arange(g1.cap) % 16
    return arrays


# fractional receiver values: the plans' per-slot scatter-adds take their
# duplicates in any order on the card (CUDA's scatter_add_ adds by
# atomics), in index order on the CPU, so sums of rewards of magnitude up
# to ~50 may differ in their last bits
RULE_ATOL = 1e-5


@pytest.mark.parametrize("max_tensor", [None, 64])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "frac"])
def test_rule_plans_gpu_match_cpu(cuda, max_tensor, integer, monkeypatch):
    """Every plan as compiled, and every rule forced onto GeneralRule
    (whole, and in blocks of at most 64 per env), on the card and on the
    CPU: triggers equal; rewards exact with integer receiver values,
    within RULE_ATOL with fractional ones."""
    from magent_tpu_torch import spec as tspec
    from magent_tpu_torch.core import rules as trules
    from magent_tpu_torch.core.state import state_from_numpy

    if max_tensor is not None:
        monkeypatch.setattr(trules.GeneralRule, "MAX_TENSOR", max_tensor)
    values = ([2, -1, 3, 1, -2, 4, 5, 1, 2, -3] if integer else
              [0.3, -0.7, 1.25, 0.1, -2.5, 0.45, 0.6, 0.05, 1.5, -0.35])
    spec = tspec.compile_spec(_rule_config(values), [37, 29])
    compiled = spec.compiled_rules()
    assert [type(p).__name__ for p in compiled] == [
        "GeneralRule"] * 4 + ["PairSharedObjectRule"]
    order = trules._symbol_order(spec.reward_rules)
    general = [trules.GeneralRule(spec, on, r, v, t, order.index)
               for on, r, v, t in spec.reward_rules]
    if max_tensor is not None:
        assert max(len(p.blocks(spec)) for p in general) > 1
    atol = 0.0 if integer else RULE_ATOL
    fired = 0
    for seed in range(3):
        arrays = _rule_arrays(spec, seed, 4, integer)
        out = {}
        for dev in (cuda, "cpu"):
            st = state_from_numpy(arrays, dev)
            nr = torch.as_tensor(arrays["next_reward"], device=dev)
            gr = torch.as_tensor(arrays["group_reward"], device=dev)
            res = []
            for plans in (compiled, general):
                r_nr, r_gr, trig = nr, gr, []
                for p in plans:
                    r_nr, r_gr, t = p.apply(spec, st, r_nr, r_gr)
                    trig.append(t.cpu())
                res.append((r_nr.cpu(), r_gr.cpu(), torch.stack(trig)))
            out[str(dev)] = res
        for (g_nr, g_gr, g_t), (c_nr, c_gr, c_t) in zip(out[str(cuda)],
                                                        out["cpu"]):
            assert torch.equal(g_t, c_t), seed
            torch.testing.assert_close(g_nr, c_nr, atol=atol, rtol=0)
            torch.testing.assert_close(g_gr, c_gr, atol=atol, rtol=0)
        # the pair rule and its general join agree on the CPU as well
        assert torch.equal(out["cpu"][0][2][-1], out["cpu"][1][2][-1])
        fired += int(out["cpu"][1][2].sum())
    assert fired >= 10


def _golden_world(name, device, **kwargs):
    """A golden scenario's GridWorld (tests/golden/scenarios.py) with its
    placements."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
    from scenarios import SCENARIOS
    from magent_tpu_torch import gridworld as tgw

    spec = SCENARIOS[name]
    env = GridWorld(spec["cfg"](tgw, spec["map_size"]), device=device,
                    **kwargs)
    env.reset()
    for h, pos in zip(env.get_handles(), spec["placements"]):
        env.add_agents(h, method="custom", pos=pos)
    return env


def _pursuit_world(device, map_size=48):
    """train_pursuit's map (examples/train_pursuit.py:16-20)."""
    env = GridWorld("pursuit", map_size=map_size, device=device)
    env.set_seed(4)
    env.reset()
    h0, h1 = env.get_handles()
    n = map_size * map_size
    env.add_walls(method="random", n=n * 0.03)
    env.add_agents(h0, method="random", n=n * 0.0125)
    env.add_agents(h1, method="random", n=n * 0.025)
    return env


@pytest.mark.parametrize("name,route", [
    ("pursuit", "quad"), ("pursuit", "sort"), ("food", "quad"),
    ("food_crumb", "quad"), ("food_crumb", "sort"), ("absorb", "quad"),
    ("turn_bodies", "quad"), ("turn_bodies", "sort")])
def test_grid_path_gridworlds_gpu_match_cpu(cuda, name, route, monkeypatch):
    """Multi-cell bodies, food, absorb and turn mode (the turn phase and
    the stacked-rotations observation) on the grid path, on the card and
    on the CPU: the same placements and actions give equal views, features,
    rewards and states (``cell_slot``, ``cell_food``, ``absorbed``, ``dir``
    included), exactly.  The fractional values are order-fixed: food eats
    and their per-cell totals add by elementwise ops in attack-priority
    order (engine ``_cumsum_xla``, ``_sum_in_order``), hp changes are
    elementwise, and the minimaps pool integer counts."""
    from magent_tpu_torch.core import engine as tengine

    if route == "sort":
        monkeypatch.setattr(tengine, "make_step", lambda sp: (
            tengine._build_step(sp, tengine._Route(grid=True, quad=False))))
    envs = [(_pursuit_world(d) if name == "pursuit" else
             _golden_world(name, d)) for d in (cuda, "cpu")]
    assert all(e._step_fn.route.quad == (route == "quad") for e in envs)
    rng = np.random.RandomState(11)
    seen_food = seen_absorbed = 0
    for step in range(8):
        for h in envs[1].get_handles():
            (gv, gf), (cv, cf) = (e.get_observation(h) for e in envs)
            np.testing.assert_array_equal(gv, cv, err_msg="views %d" % step)
            np.testing.assert_array_equal(gf, cf)
            acts = rng.randint(0, envs[1].get_action_space(h)[0],
                               envs[1].get_num(h)).astype(np.int32)
            for e in envs:
                e.set_action(h, acts)
        assert envs[0].step() == envs[1].step()
        for h in envs[1].get_handles():
            np.testing.assert_array_equal(envs[0].get_reward(h),
                                          envs[1].get_reward(h))
        for e in envs:
            e.clear_dead()
        for field in FIELDS:
            assert torch.equal(getattr(envs[0].state, field).cpu(),
                               getattr(envs[1].state, field)), (field, step)
        seen_food += int((envs[1].state.cell_food >= 0).sum())
        seen_absorbed += int(envs[1].state.absorbed.sum())
    if name.startswith("food"):
        assert seen_food > 0
    if name == "absorb":
        assert seen_absorbed > 0


def test_food_sums_gpu_match_cpu(cuda):
    """The food phase's two f32 sums, an XLA-blocked cumulative sum and the
    per-segment sums in row order, give the CPU's bits on the card, on
    random fractional values with segments up to the bound."""
    from magent_tpu_torch.core import engine as tengine

    rng = np.random.RandomState(5)
    for N in (1, 15, 16, 17, 300, 4099):
        vals = torch.from_numpy(rng.uniform(0, 4, (3, N)).astype(np.float32))
        keys = torch.from_numpy(np.sort(rng.randint(0, max(N // 3, 1),
                                                    (3, N)), 1))
        start = tengine._segment_starts(keys)
        for fn in (lambda v, s: tengine._cumsum_xla(v),
                   lambda v, s: tengine._segment_cumsum(v, s,
                                                        tengine._cumsum_xla),
                   lambda v, s: tengine._sum_in_order(v, s, 16)):
            want = fn(vals, start)
            got = fn(vals.to(cuda), start.to(cuda)).cpu()
            assert torch.equal(got, want), N


def _turn_venv(device, obs_dtype):
    """``scripts/bench_pursuit.py --turn``'s config at map 40, B=4: 2x2
    predators facing at random and 1x1 prey on the odd cells."""
    from magent_tpu_torch import gridworld as tgw

    cfg = tgw.Config()
    cfg.set({"map_width": 40, "map_height": 40, "turn_mode": True})
    pred = cfg.register_agent_type(
        "predator", {'width': 2, 'length': 2, 'hp': 1, 'speed': 1,
                     'view_range': tgw.CircleRange(5),
                     'attack_range': tgw.CircleRange(2),
                     'attack_penalty': -0.2})
    prey = cfg.register_agent_type(
        "prey", {'width': 1, 'length': 1, 'hp': 1, 'speed': 1.5,
                 'view_range': tgw.CircleRange(4),
                 'attack_range': tgw.CircleRange(0)})
    a = tgw.AgentSymbol(cfg.add_group(pred), index='any')
    b = tgw.AgentSymbol(cfg.add_group(prey), index='any')
    cfg.add_reward_rule(tgw.Event(a, 'attack', b), receiver=[a, b],
                        value=[1, -1])
    rng = np.random.RandomState(5)
    cells = rng.permutation(19 * 19)[:20 + 40]
    preds = [[1 + 2 * (c % 19), 1 + 2 * (c // 19), rng.randint(4)]
             for c in cells[:20]]
    prey = [[1 + 2 * (c % 19), 1 + 2 * (c // 19), 0] for c in cells[20:]]
    return VecGridWorld(cfg, [20, 40], 4, placements=[preds, prey],
                        obs_dtype=obs_dtype, device=device)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["window_gather", "window_gather_banded",
                                   "per_direction"])
def test_turn_lockstep_gpu_matches_cpu(cuda, route, dtype, monkeypatch):
    """Turn mode's lockstep loop on each observation route, on the card
    and on the CPU from the same keys: views (their bits), features,
    actions and states equal, exactly; the card's run launches the
    route's window kernel."""
    if route != "window_gather":
        monkeypatch.setattr(tobserve, "VMEM_IMAGE_BUDGET", 0)
    if route == "per_direction":
        monkeypatch.setattr(tobserve, "_BAND_BUDGET", 0)
    obs_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    envs = [_turn_venv(d, obs_dtype) for d in (cuda, "cpu")]
    assert [o.route for o in envs[0]._observe] == [route] * 2
    states = [e.reset(trandom.PRNGKey(3)) for e in envs]
    key = trandom.PRNGKey(4)
    counter = route + ("_bf16" if dtype == "bf16" else "")
    before = ops.launch_counts().get(counter, 0)
    for step in range(4):
        keys = trandom.split(key)
        key, akey = keys[0], keys[1]
        for (gv, gf), (cv, cf) in zip(*(e.observe_all(st)
                                        for e, st in zip(envs, states))):
            bits = torch.int16 if dtype == "bf16" else torch.int32
            assert torch.equal(gv.cpu().view(bits), cv.view(bits)), step
            assert torch.equal(gf.cpu(), cf), step
        acts = [e.random_actions(akey) for e in envs]
        assert torch.equal(acts[0].cpu(), acts[1])
        states = [e.transition(st, a)[0] for e, st, a in zip(envs, states,
                                                              acts)]
        for field in FIELDS:
            assert torch.equal(getattr(states[0], field).cpu(),
                               getattr(states[1], field)), (field, step)
    if route != "per_direction":
        assert ops.launch_counts()[counter] - before == 8
    assert len(torch.unique(states[1].dir)) == 4


PAIR_KERNELS = ("occupant", "rank_prefix", "move_resolve", "rank_prefix_hp",
                "move_claims", "occupant_rect", "rect_first_overlap",
                "occupant_rect_seg", "rect_first_overlap_seg",
                "rank_prefix_seg")


@pytest.mark.parametrize("name", ["battle_melee", "food_crumb",
                                  "turn_bodies"])
def test_sequential_gridworld_gpu_matches_cpu(cuda, name):
    """``engine_mode="sequential"`` on the card and on the CPU: the
    golden's placements and a seeded action stream give equal views,
    features, rewards, attack events and states after every step, exactly,
    over the golden's steps.  The step runs on the host, so it launches no
    pair kernel; the observation launches the window kernels."""
    envs = [_golden_world(name, d, engine_mode="sequential")
            for d in (cuda, "cpu")]
    rng = np.random.RandomState(5)
    before = ops.launch_counts()
    for step in range(40):
        for h in envs[1].get_handles():
            (gv, gf), (cv, cf) = (e.get_observation(h) for e in envs)
            np.testing.assert_array_equal(gv, cv, err_msg="views %d" % step)
            np.testing.assert_array_equal(gf, cf)
            acts = rng.randint(0, envs[1].get_action_space(h)[0],
                               envs[1].get_num(h)).astype(np.int32)
            for e in envs:
                e.set_action(h, acts)
        done = [e.step() for e in envs]
        assert done[0] == done[1]
        assert envs[0]._last_attack_events == envs[1]._last_attack_events
        for h in envs[1].get_handles():
            np.testing.assert_array_equal(envs[0].get_reward(h),
                                          envs[1].get_reward(h))
        for e in envs:
            e.clear_dead()
        for field in FIELDS:
            got, want = getattr(envs[0].state, field), getattr(envs[1].state,
                                                               field)
            assert got.device.type == "cuda" and got.dtype == want.dtype
            assert torch.equal(got.cpu(), want), (field, step)
        if done[0]:
            break
    counts = ops.launch_counts()
    launched = {k: counts[k] - before[k] for k in counts}
    assert not any(launched[k] for k in PAIR_KERNELS), launched
    assert sum(launched.values()) >= 2 * (step + 1), launched


def test_fast_snake_gpu_matches_cpu(cuda):
    """The fast DiscreteSnake at the JAX package's default map (100 x 100,
    view 21 x 21, caps 256, max_length 48) on the card and on the CPU: equal
    views, features, rewards and states (threefry key included) over 20
    steps; one ``window_gather`` launch per observation on the card."""
    from magent_tpu_torch import discrete_snake as tds

    envs = []
    for d in (cuda, "cpu"):
        cfg = tds.Config()
        cfg.set({"seed": 0})
        env = tds.DiscreteSnake(cfg, device=d)
        env.add_walls(method="random", n=100)
        env.add_food(method="random", n=500)
        env.add_agent(method="random", n=256)
        envs.append(env)
    rng = np.random.RandomState(3)
    before = ops.launch_counts()["window_gather"]
    for step in range(20):
        (gv, gf), (cv, cf) = (e.get_observation() for e in envs)
        np.testing.assert_array_equal(gv.view(np.int32), cv.view(np.int32))
        np.testing.assert_array_equal(gf, cf)
        acts = rng.randint(0, 5, envs[1].get_num()).astype(np.int32)
        for e in envs:
            e.set_action(0, acts)
            e.step()
        np.testing.assert_array_equal(envs[0].get_reward(),
                                      envs[1].get_reward())
        for e in envs:
            e.clear_dead()
        for field in tds.SNAKE_FIELDS:
            assert torch.equal(getattr(envs[0].state, field).cpu(),
                               getattr(envs[1].state, field)), (field, step)
    assert ops.launch_counts()["window_gather"] - before == 20

