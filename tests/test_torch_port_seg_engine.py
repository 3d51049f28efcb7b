"""The port's y-segmented rect step and banded observation against the JAX
package: pursuit on one world at map 250 (A = 2343 slots, three segments of
1024) with ``layout(250, seed=5)``, without and with 3% interior walls, and
the same populations crowded into a 40-row band.

The port's step takes the segmented sweeps, picked through
``engine._build_step`` (its route takes them from QUAD_MAX_SINGLE = 16,384
slots); the JAX package's step is its unsegmented gridless step, pinned with
``MAGENT_ATTACK_PATH=quad`` (off the TPU it never takes the segmented
sweeps, engine.py:196, and without the pin it would take the grid path
above 1024 slots).  Both answer the same questions, so every state field
must be equal after every step.  The views go through the banded window
gather with the port's ``VMEM_IMAGE_BUDGET`` shrunk to 1 byte, and must
equal the JAX views exactly.  Also the route of real pursuit specs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magent_tpu_torch.builtin.config import pursuit as tpursuit
from magent_tpu_torch import spec as tspec
from magent_tpu_torch.core import engine as tengine
from magent_tpu_torch.core import observe as tobserve
from magent_tpu_torch.ops import attack_prefix as tap
from magent_tpu_torch.parallel.vec_env import _wall_map

from _torch_port_cases import (Pair, arrays_of, assert_obs_equal,
                               assert_states_equal, biased_actions, jax_state,
                               key_pair, perturb, port_state)

MAP, SEED, N_STEPS = 250, 5, 4
SEG = tengine._Route(grid=False, quad=True, seg=True)


def _seg_step(pair):
    """The port's step of ``pair`` on the segmented route, with the
    layout's packed wall grid."""
    spec = pair.spec
    wall_ctx = None
    if len(pair.walls):
        wall_ctx = tengine._wall_rect_code(spec, _wall_map(spec, pair.walls))
    return tengine._build_step(spec, SEG, wall_ctx)


def _band_layout(seed):
    """layout(250)'s populations crowded into rows 100-139 (about half the
    band's cells taken): every segment boundary falls inside the crowd, so
    pairs across it attack, block and claim."""
    rng = np.random.RandomState(seed)
    taken = np.zeros((MAP, MAP), bool)
    groups = []
    for n, size in ((781, 2), (1562, 1)):
        rows = []
        while len(rows) < n:
            x, y = rng.randint(1, MAP - 3), rng.randint(100, 140)
            if not taken[y:y + size, x:x + size].any():
                taken[y:y + size, x:x + size] = True
                rows.append([x, y, 0])
        groups.append(rows)
    return groups, []


LAYOUTS = {"border": lambda: tpursuit.layout(MAP, SEED),
           "walls3pct": lambda: tpursuit.layout(MAP, SEED, 0.03),
           "band": lambda: _band_layout(SEED)}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def pair(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGENT_ATTACK_PATH", "quad")
        placements, walls = LAYOUTS[request.param]()
        p = Pair("pursuit", MAP, [len(g) for g in placements], 1,
                 placements=placements, walls=walls or None)
        p.walls = walls
        p.seg_step = _seg_step(p)
        yield p


def test_seg_route_of_the_pair(pair):
    """Below QUAD_MAX_SINGLE the port's own route is the unsegmented one;
    the test's step takes the segmented sweeps."""
    assert pair.spec.n_agents_cap == 2343
    assert pair.tv._step.route == tengine._Route(grid=False, quad=True)
    assert pair.seg_step.route == SEG


def test_seg_steps_match_jax(pair):
    """Several raw steps of biased actions from a perturbed reset: every
    field after every step; the plan never overflows, so the windows are
    what the step sweeps."""
    spec = pair.spec
    jkey, _ = key_pair(SEED)
    arrays = perturb(arrays_of(pair.reset(jkey)), spec, SEED, dead_frac=0.05)
    js, ts = jax_state(arrays), port_state(arrays)
    ops = set()
    for step in range(N_STEPS):
        actions = biased_actions(spec, 1, 100 + step, attack_frac=0.5)
        js = pair.step(js, jnp.asarray(actions))
        ts = pair.seg_step(ts, torch.from_numpy(actions))
        assert_states_equal(ts, js, "step %d" % step)
        ops.update(np.unique(np.asarray(js.last_op)).tolist())
        sort_y = torch.sort(ts.y[0], stable=True).values
        # the move and occupant margin (4); the rank sweep's (8) plans a
        # window of all 3072 rows here
        _, P, _, overflow = tap._seg_plan(
            sort_y, 4, tengine._seg_win_hint(spec, 2343, 4))
        assert P == 2048 and not bool(overflow)
    # attacks and collisions happened; pursuit's predators deal no damage
    assert {tspec.OP_ATTACK, tspec.OP_COLLIDE} <= ops
    assert tspec.OP_KILL not in ops


def test_seg_step_plans_once_per_margin(pair, monkeypatch):
    """A step plans once per distinct margin: the occupant and both move
    sweeps share margin 4, the rank sweep has margin 8."""
    margins = []
    plan = tap._seg_plan

    def counting_plan(sort_y, margin, seg_win=None):
        margins.append(margin)
        return plan(sort_y, margin, seg_win)

    monkeypatch.setattr(tap, "_seg_plan", counting_plan)
    jkey, _ = key_pair(SEED)
    ts = port_state(arrays_of(pair.reset(jkey)))
    actions = biased_actions(pair.spec, 1, 3, attack_frac=0.5)
    pair.seg_step(ts, torch.from_numpy(actions))
    assert sorted(margins) == [4, 8]


def test_banded_views_match_jax(pair, monkeypatch):
    """The views of both groups on the banded route (budget 1 byte) equal
    the JAX views, before and after a step."""
    monkeypatch.setattr(tobserve, "VMEM_IMAGE_BUDGET", 1)
    observe = [tobserve.make_observe(pair.spec, g) for g in range(2)]
    assert [o.route for o in observe] == ["window_gather_banded"] * 2
    jkey, _ = key_pair(SEED + 1)
    arrays = perturb(arrays_of(pair.reset(jkey)), pair.spec, SEED,
                     dead_frac=0.1)
    js, ts = jax_state(arrays), port_state(arrays)
    for tag in ("reset", "step"):
        grids = observe[0].grids_fn(ts)
        assert_obs_equal([o(ts, grids) for o in observe],
                         pair.observe_all(js), pair.spec, tag)
        actions = biased_actions(pair.spec, 1, 7)
        js = pair.step(js, jnp.asarray(actions))
        ts = pair.seg_step(ts, torch.from_numpy(actions))


def _pursuit_spec(map_size):
    n = map_size * map_size
    caps = [int(n * 0.0125), int(n * 0.025)]
    return tspec.compile_spec(tpursuit.get_config(map_size), caps)


@pytest.mark.parametrize("map_size,A,route", [
    (660, 16335, "quad"), (661, 16384, "seg"), (662, 16434, "seg"),
    (1000, 37500, "seg"), (1450, 78843, "Queue 1 item 7")])
def test_pursuit_route_by_map(map_size, A, route):
    """One pursuit world at the reference density: quad below
    QUAD_MAX_SINGLE = 16,384 slots, segmented from it (inclusive, as the
    JAX package's _use_seg) to 65,536, and beyond the grid path's sort
    branches ("Queue 1 item 7", the ROADMAP item that ported them); the
    observation's banded route from map 500."""
    spec = _pursuit_spec(map_size)
    assert spec.n_agents_cap == A
    step = tengine.make_step(spec, maintain_grid=False, n_envs=1)
    if route == "Queue 1 item 7":
        assert step.route == tengine._Route(grid=True, quad=False)
    else:
        assert step.route == tengine._Route(grid=False, quad=True,
                                            seg=route == "seg")
    assert [tobserve.make_observe(spec, g).route for g in range(2)] == [
        "window_gather_banded"] * 2


def test_observe_routes_by_image_size():
    """Pursuit takes the banded route from map 500 (6.41 MB images),
    window_gather between a quarter of the budget and the budget (map 211:
    1.58 MB; map 400: 4.36 MB; the JAX package's fourfold replica budget)
    and window_gather4 below (map 210: 1.44 MB); battle at map 200 (1.97
    MB) keeps its route."""
    from magent_tpu_torch.builtin.config import battle

    for map_size, want in ((64, "window_gather4"), (210, "window_gather4"),
                           (211, "window_gather"), (400, "window_gather"),
                           (500, "window_gather_banded")):
        spec = _pursuit_spec(map_size)
        assert [tobserve.make_observe(spec, g).route for g in range(2)] == [
            want] * 2, map_size
    spec = tspec.compile_spec(battle.get_config(200), [1000, 1000])
    assert tobserve.make_observe(spec, 0).route == "window_gather"


def test_map_1000_world_takes_the_seg_route():
    """The reference's own pursuit scale, one world at map 1000 with
    bench_pursuit's placements (seed 5), constructs (on the CPU here) with
    the segmented step and the banded observation of both groups."""
    from magent_tpu_torch.parallel import VecGridWorld

    placements, _ = tpursuit.layout(1000, seed=5)
    venv = VecGridWorld(tpursuit.get_config(1000), [12500, 25000], n_envs=1,
                        placements=placements, device="cpu")
    assert venv._step.route == SEG
    assert [o.route for o in venv._observe] == ["window_gather_banded"] * 2
