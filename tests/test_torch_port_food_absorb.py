"""Food and absorb on the port's grid path against the JAX package's.

- The golden scenarios ``food``, ``food_crumb`` and ``absorb`` (and
  ``pursuit``, in ``test_torch_port_rect_grid.py``) go through ``tests/golden/scenarios.py``'s ``run_scenario`` with a shim in
  place of the port's ``GridWorld``: every call goes to
  ``magent_tpu.GridWorld`` and to ``magent_tpu_torch.GridWorld(device=
  "cpu")``, and every return value (the trace) and the whole state
  (``cell_slot``, ``cell_food``, ``absorbed`` and ``done`` included) must be
  equal after every call; food_crumb and absorb also on the sort branches
  (the JAX package pinned with ``MAGENT_ATTACK_PATH=sort``).
- The port's traces keep the episode invariants of
  ``tests/test_fast_parity.py`` against the C++ goldens.
- Three eaters of one food cell whose eats sum to different f32 totals in
  different orders: the cell's remainder lands either side of the 0.1
  deletion threshold, and must equal the JAX package's, which adds the
  eats in attack-priority order.
- Food rendering and ``can_absorb`` minimaps against the JAX package's
  ``make_observe(..., interpret=True)``.
- Lockstep ``VecGridWorld`` batches of a food and of an absorb config,
  which both packages step on the grid path.

Every comparison is exact, except the pooled minimap channels (atol 1e-6,
``_torch_port_cases.MINIMAP_ATOL``)."""

import itertools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magent_tpu as jmagent
from magent_tpu import gridworld as jgw
from magent_tpu.core import observe as jobserve

import magent_tpu_torch as tmagent
from magent_tpu_torch import gridworld as tgw
from magent_tpu_torch.core import engine as tengine
from magent_tpu_torch.core import observe as tobserve
from magent_tpu_torch.core.state import state_from_numpy
from magent_tpu_torch.spec import OP_COLLIDE, OP_KILL

from _torch_port_cases import (Pair, arrays_of, assert_obs_equal,
                               assert_states_equal, jax_state, key_pair,
                               split_pair)
from test_torch_port_gridworld import Dual

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))

from scenarios import SCENARIOS, flatten_trace, run_scenario  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
NAMES = ("pursuit", "food", "food_crumb", "absorb")


def _sort_route(monkeypatch):
    monkeypatch.setenv("MAGENT_ATTACK_PATH", "sort")
    monkeypatch.setattr(tengine, "make_step", lambda sp: (
        tengine._build_step(sp, tengine._Route(grid=True, quad=False))))


def _dual_shim(name, worlds):
    """A module for ``run_scenario`` whose ``GridWorld`` is a :class:`Dual`
    of both packages on the scenario's config (built in each package)."""
    def make(jcfg):
        tcfg = SCENARIOS[name]["cfg"](tgw, SCENARIOS[name]["map_size"])
        env = Dual(jmagent.GridWorld(jcfg),
                   tmagent.GridWorld(tcfg, device="cpu"))
        worlds.append(env)
        return env
    return types.SimpleNamespace(gridworld=jgw, GridWorld=make)


class _Seen:
    """What a run reached, read from the port's state after every step."""

    def __init__(self, env):
        self.kills = self.collides = self.absorbed = 0
        self.food_cells = self.eaten = 0
        step = env.t.step

        def watched():
            before = env.t.state.cell_food
            done = step()
            st = env.t.state
            self.kills += int((st.last_op == OP_KILL).sum())
            self.collides += int((st.last_op == OP_COLLIDE).sum())
            self.absorbed = max(self.absorbed, int(st.absorbed.sum()))
            self.food_cells = max(self.food_cells,
                                  int((st.cell_food >= 0).sum()))
            self.eaten += int(((st.cell_food < before)
                               & (before >= 0)).sum())
            return done
        env.t.step = watched


def run_dual_scenario(name):
    """Drive one golden scenario through both packages -> (the port's
    trace, the :class:`Dual` world, what its steps reached)."""
    worlds, seen = [], []
    shim = _dual_shim(name, worlds)
    make = shim.GridWorld

    def watched(jcfg):
        env = make(jcfg)
        seen.append(_Seen(env))
        return env
    shim.GridWorld = watched
    trace = run_scenario(shim, name)
    assert trace["steps"] == SCENARIOS[name]["steps"]
    return trace, worlds[0], seen[0]


@pytest.mark.parametrize("name,route", [
    ("food", "quad"), ("food_crumb", "quad"), ("absorb", "quad"),
    ("food_crumb", "sort"), ("absorb", "sort")])
def test_golden_scenario_matches_jax(name, route, monkeypatch):
    """(The pursuit scenario: ``test_torch_port_rect_grid.py``.)"""
    if route == "sort":
        _sort_route(monkeypatch)
    _, env, seen = run_dual_scenario(name)
    assert env.t._step_fn.route == tengine._Route(grid=True,
                                                  quad=route == "quad")
    # the scenario reaches the mechanics it is named for
    if name.startswith("food"):
        assert seen.kills > 0 and seen.food_cells > 0 and seen.eaten > 0
    else:
        assert seen.absorbed > 0 and seen.collides > 0


def _winner(num0, num1):
    for step in range(len(num0)):
        if num0[step] == 0:
            return 0
        if num1[step] == 0:
            return 1
    return -1


@pytest.mark.parametrize("name", NAMES)
def test_port_traces_keep_golden_invariants(name):
    """``tests/test_fast_parity.py``'s episode invariants, the port's trace
    against the C++ engine's golden: the same group goes extinct (or none
    does), and the episode length stays in the same regime."""
    golden = dict(np.load(os.path.join(GOLDEN_DIR, "golden_%s.npz" % name)))
    port = types.SimpleNamespace(
        gridworld=tgw,
        GridWorld=lambda cfg: tmagent.GridWorld(cfg, device="cpu"))
    trace = flatten_trace(run_scenario(port, name), 2)
    assert _winner(trace["num_0"], trace["num_1"]) == _winner(
        golden["num_0"], golden["num_1"])
    g_steps, f_steps = int(golden["steps"]), int(trace["steps"])
    budget = SCENARIOS[name]["steps"]
    if g_steps == budget:
        assert f_steps >= int(0.6 * budget)
    else:
        assert abs(f_steps - g_steps) <= max(5, budget // 3)


# three eat abilities whose f32 sums round three ways by order: 8 minus the
# total is 0.10000038 (the food stays) or 0.09999943 (it is deleted)
EATS = (3.27, 2.91, 1.72)
FOOD = 8.0


def _eaters_config(gw):
    cfg = gw.Config()
    cfg.set({"map_width": 12, "map_height": 12, "food_mode": True})
    for k, eat in enumerate(EATS):
        t = cfg.register_agent_type(
            "eater%d" % k,
            {'width': 1, 'length': 1, 'hp': 10, 'speed': 1,
             'view_range': gw.CircleRange(2),
             'attack_range': gw.CircleRange(1), 'damage': 0,
             'eat_ability': eat, 'step_recover': 0.1})
        cfg.add_group(t)
    return cfg


def _attack_action(spec, slot, dx, dy):
    """The attack action of ``slot`` that hits (x + dx, y + dy) (NORTH)."""
    for k in range(int(spec.s_n_action[slot] - spec.s_attack_base[slot])):
        if (int(spec.s_att_x_offset[slot] + spec.s_att_dx[slot, k]) == dx
                and int(spec.s_att_y_offset[slot] + spec.s_att_dy[slot, k])
                == dy):
            return int(spec.s_attack_base[slot]) + k
    raise AssertionError("no attack reaches (%d, %d)" % (dx, dy))


@pytest.mark.parametrize("seed", [0, 1])
def test_food_eats_add_in_priority_order(seed):
    """Three eaters, one per group, attack one food cell of 8.0 from three
    sides, six steps in a row (the food restored before each).  All eat in
    full; the cell keeps 8 minus their total, which in f32 depends on the
    order of the adds (checked here in numpy), and is deleted below 0.1.
    The port adds in attack-priority order, as the JAX package's
    scatter-add does on the CPU; each step draws another priority order,
    and the steps see the food both kept and deleted."""
    f32 = np.float32
    totals = {f32(f32(f32(0) + f32(EATS[a])) + f32(EATS[b])) + f32(EATS[c])
              for a, b, c in itertools.permutations(range(3))}
    assert len(totals) == 3
    assert any(f32(FOOD) - t < f32(0.1) for t in totals)
    assert any(f32(FOOD) - t >= f32(0.1) for t in totals)

    env = Dual(jmagent.GridWorld(_eaters_config(jgw)),
               tmagent.GridWorld(_eaters_config(tgw), device="cpu"))
    env.set_seed(seed)
    env.reset()
    fx, fy = 5, 5
    sides = ((4, 5), (6, 5), (5, 4))
    for h, (x, y) in zip(env.get_handles(), sides):
        env.add_agents(h, method="custom", pos=[[x, y]])
    food = np.full((12, 12), -1.0, np.float32)
    food[fy, fx] = FOOD
    food[1, 1] = 0.05  # uneaten food below 0.1 stays
    spec = env.spec
    outcomes = set()
    for _ in range(6):
        env.j.state = env.j.state.replace(cell_food=jnp.asarray(food))
        env.t.state = env.t.state.replace(
            cell_food=torch.from_numpy(food[None].copy()))
        for h, (x, y) in zip(env.get_handles(), sides):
            slot = spec.groups[h.value].offset
            env.set_action(h, np.array([_attack_action(spec, slot, fx - x,
                                                       fy - y)], np.int32))
        env.step()
        left = env.t.state.cell_food[0].numpy()
        assert left[1, 1] == f32(0.05)
        if left[fy, fx] == -1.0:
            outcomes.add("deleted")
        else:
            assert f32(FOOD) - left[fy, fx] in totals
            outcomes.add("kept")
    assert outcomes == {"deleted", "kept"}


def _absorb_state(env, seed):
    """The absorb scenario's layout a few steps in, with some goals marked
    absorbed and some agents dead (left uncleared)."""
    h_goal, h_agent = env.get_handles()
    env.set_seed(seed)
    env.reset()
    spec = SCENARIOS["absorb"]
    for h, pos in zip((h_goal, h_agent), spec["placements"]):
        env.add_agents(h, method="custom", pos=pos)
    rng = np.random.RandomState(seed)
    for _ in range(4):
        for h in (h_goal, h_agent):
            env.set_action(h, rng.randint(0, env.get_action_space(h)[0],
                                          env.get_num(h)).astype(np.int32))
        env.step()
    arrays = {k: v[None].copy() for k, v in arrays_of(env.j.state).items()}
    n_goal = env.get_num(h_goal)
    arrays["absorbed"][0, :n_goal] |= rng.uniform(size=n_goal) < 0.4
    off = env.spec.groups[h_agent.value].offset
    arrays["dead"][0, off:off + 4] = True
    return arrays


def _food_state(env, seed):
    """The food scenario's layout with random food cells, some on walls."""
    spec = SCENARIOS["food"]
    env.set_seed(seed)
    env.reset()
    env.add_walls(method="random", n=12)
    for h, pos in zip(env.get_handles(), spec["placements"]):
        env.add_agents(h, method="custom", pos=pos)
    arrays = {k: v[None].copy() for k, v in arrays_of(env.j.state).items()}
    rng = np.random.RandomState(seed)
    H, W = arrays["cell_food"].shape[1:]
    food = np.where(rng.uniform(size=(H, W)) < 0.2,
                    rng.uniform(0, 8, size=(H, W)), -1.0).astype(np.float32)
    food[arrays["cell_wall"][0] & (rng.uniform(size=(H, W)) < 0.5)] = 3.0
    arrays["cell_food"] = food[None]
    return arrays


@pytest.mark.parametrize("name", ["food", "absorb"])
@pytest.mark.parametrize("seed", [0, 1])
def test_food_and_absorb_views_match_interpret(name, seed):
    """Food cells render as channel 1 under walls; ``can_absorb``
    observers pool only the agents not absorbed (the absorb config has the
    minimap): views and features of both groups against the JAX package's
    observe with its Pallas kernels in interpret mode."""
    cfg = SCENARIOS[name]["cfg"]
    map_size = SCENARIOS[name]["map_size"]
    env = Dual(jmagent.GridWorld(cfg(jgw, map_size), caps=16),
               tmagent.GridWorld(cfg(tgw, map_size), caps=16, device="cpu"))
    arrays = (_food_state if name == "food" else _absorb_state)(env, seed)
    spec = env.t.spec
    jspec = env.j.spec
    ts = state_from_numpy(arrays, "cpu")
    js = jax_state(arrays)
    t_obs = [tobserve.make_observe(spec, g)(ts) for g in range(spec.n_groups)]
    # jitted, as the JAX package runs it: its compiler folds hp / hp_max
    # into a multiply, as the port computes it
    j_obs = [jax.jit(jobserve.make_observe(jspec, g, interpret=True))(js)
             for g in range(jspec.n_groups)]
    assert_obs_equal(t_obs, j_obs, spec, "%s seed %d" % (name, seed))
    if name == "food":
        assert (arrays["cell_food"][0] >= 0).any()
    else:
        assert spec.groups[0].type.can_absorb
        assert arrays["absorbed"].any()


@pytest.mark.parametrize("name", ["food_crumb", "absorb"])
def test_vec_food_and_absorb_take_the_grid_path(name):
    """A lockstep VecGridWorld (B=2, random placement) of a food and of an
    absorb config: both packages leave the gridless path for the grid
    path, and reset, 6 transitions and observe_all are equal (the batched
    cumulative sum of the eats rounds as the unbatched one)."""
    cfg = SCENARIOS[name]["cfg"]
    map_size = SCENARIOS[name]["map_size"]
    p = Pair((lambda m: cfg(tgw, m), lambda m: cfg(jgw, m)), map_size,
             [16, 16], 2)
    assert p.tv._step.route == tengine._Route(grid=True, quad=True)
    jkey, tkey = key_pair(3)
    js, ts = p.reset(jkey), p.tv.reset(tkey)
    assert_states_equal(ts, js, "reset")
    jkey, tkey = key_pair(4)
    food = absorbed = 0
    for step in range(6):
        tag = "%s step %d" % (name, step)
        assert_obs_equal(p.tv.observe_all(ts), p.observe_all(js), p.spec, tag)
        (jkey, jsub), (tkey, tsub) = split_pair(jkey, tkey)
        ja, ta = p.random_actions(jsub), p.tv.random_actions(tsub)
        js, jr, _, jd = p.transition(js, ja)
        ts, tr, _, td = p.tv.transition(ts, ta)
        assert_states_equal(ts, js, tag)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        food += int((ts.cell_food >= 0).sum())
        absorbed += int(ts.absorbed.sum())
    assert (food if name == "food_crumb" else absorbed) > 0
