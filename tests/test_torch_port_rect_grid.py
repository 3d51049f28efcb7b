"""Multi-cell bodies on the port's grid path against the JAX package's:
``_clear_body`` and ``_fill_body``, the grid step on pursuit specs (maps
24-48 with 3% walls, and the mixed 2x2 / 1x3 config of max body 3) on the
pair kernels and on the sort branches (the JAX package pinned with
``MAGENT_ATTACK_PATH``), ``GridWorld("pursuit")`` placed as
``examples/train_pursuit.py`` places it, call by call, and a
``VecGridWorld`` pursuit batch past ``QUAD_MAX_AGENTS`` (the constant shrunk
in both packages), which leaves the gridless path for the grid.  Every
state field is compared exactly, ``cell_slot`` included: the step is
integer logic plus the same f32 elementwise ops in the same order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magent_tpu as jmagent
from magent_tpu.core import engine as jengine
from magent_tpu.ops import attack_prefix as jap

from magent_tpu_torch import spec as tspec
from magent_tpu_torch.builtin.config import pursuit as tpursuit
from magent_tpu_torch.core import engine as tengine
from magent_tpu_torch.core.state import state_from_numpy
from magent_tpu_torch.ops import attack_prefix as tap
from magent_tpu_torch.spec import OP_ATTACK, OP_COLLIDE

from _torch_port_cases import (CONFIGS, Pair, assert_obs_equal,
                               assert_states_equal, biased_actions, key_pair,
                               split_pair)
from test_torch_port_food_absorb import run_dual_scenario
from test_torch_port_grid_engine import _batched
from test_torch_port_gridworld import dual
from test_torch_port_rect_engine import _mixed_config

import magent_tpu_torch as tmagent

N_STEPS = 5
# name -> (port and JAX config constructors, map size, agents per group)
WORLDS = {
    "pursuit24": (CONFIGS["pursuit"], 24, (7, 14)),
    "pursuit48": (CONFIGS["pursuit"], 48, (28, 57)),
    "mixed32": ((_mixed_config(tmagent), _mixed_config(jmagent)), 32,
                (14, 14)),
}


def _jax_world(name, seed):
    """A JAX GridWorld placed as examples/train_pursuit.py's generate_map
    places it: 3% of the cells as random walls, then random agents."""
    (_, jcfg), map_size, counts = WORLDS[name]
    env = jmagent.GridWorld(jcfg(map_size))
    env.set_seed(seed)
    env.reset()
    env.add_walls(method="random", n=map_size * map_size * 0.03)
    for h, n in zip(env.get_handles(), counts):
        env.add_agents(h, method="random", n=n)
    return env


@pytest.mark.parametrize("max_body", [2, 3])
@pytest.mark.parametrize("fill", [False, True])
def test_set_bodies_matches_clear_and_fill_body(max_body, fill):
    """One scatter over the max_body^2 offsets writes the grid that the JAX
    package's cell-by-cell ``_clear_body`` / ``_fill_body`` write, on
    disjoint bodies of every size of the spec, some masked out."""
    name = "pursuit48" if max_body == 2 else "mixed32"
    env = _jax_world(name, 7)
    js = env.state
    spec = tspec.compile_spec(WORLDS[name][0][0](WORLDS[name][1]), env._caps)
    assert spec.max_body_w == max_body
    rng = np.random.RandomState(max_body)
    A = spec.n_agents_cap
    mask = np.asarray(js.active) & (rng.uniform(size=A) < 0.6)
    grid = np.asarray(js.cell_slot)
    bw, bh = spec.s_width, spec.s_length  # every body faces NORTH
    slots = np.arange(A, dtype=np.int32)
    if fill:
        # move every masked body one cell right onto an emptied grid
        want = jengine._fill_body(jnp.full_like(js.cell_slot, -1),
                                  jnp.asarray(mask), js.x + 1, js.y,
                                  jnp.asarray(bw), jnp.asarray(bh),
                                  jnp.asarray(slots), max_body)
    else:
        want = jengine._clear_body(js.cell_slot, jnp.asarray(mask), js.x,
                                   js.y, jnp.asarray(bw), jnp.asarray(bh),
                                   max_body)
    T = tengine._Tables(spec, "cpu")
    x, y, dirs = (torch.from_numpy(np.array(v))[None]
                  for v in (js.x, js.y, js.dir))
    if fill:
        got = tengine._set_bodies(torch.full((1,) + grid.shape, -1,
                                             dtype=torch.int32),
                                  torch.from_numpy(mask)[None], x + 1, y, T,
                                  dirs, T.slots)
    else:
        got = tengine._set_bodies(torch.from_numpy(grid.copy())[None],
                                  torch.from_numpy(mask)[None], x, y, T,
                                  dirs, -1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert (np.asarray(want) != (-1 if fill else grid)).any()


def _routes(route, monkeypatch):
    """Pin the JAX package's route -> the port's step constructor on it."""
    if route == "sort":
        monkeypatch.setenv("MAGENT_ATTACK_PATH", "sort")
        return lambda sp: tengine._build_step(
            sp, tengine._Route(grid=True, quad=False))
    monkeypatch.setenv("MAGENT_ATTACK_PATH", "quad")
    return tengine.make_step


@pytest.mark.parametrize("route", ["quad", "sort"])
@pytest.mark.parametrize("name,seed", [("pursuit24", 0), ("pursuit48", 1),
                                       ("mixed32", 2)])
def test_grid_step_matches_jax(name, seed, route, monkeypatch):
    """Chained steps and clear_dead from one placed state: every field after
    every call; collisions happen, and pursuit's predators attack."""
    make = _routes(route, monkeypatch)
    env = _jax_world(name, seed)
    jstep = jax.jit(jengine.make_step(env.spec))
    jclear = jax.jit(jengine.make_clear_dead(env.spec))
    sp = tspec.compile_spec(WORLDS[name][0][0](WORLDS[name][1]), env._caps)
    tstep, tclear = make(sp), tengine.make_clear_dead(sp)
    assert tstep.route == tengine._Route(grid=True, quad=route == "quad")
    js = env.state
    ts = state_from_numpy(_batched(js), "cpu")
    ops = []
    for i in range(N_STEPS):
        actions = biased_actions(sp, 1, 10 * seed + i, attack_frac=0.4)
        js = jstep(js, jnp.asarray(actions[0]))
        ts = tstep(ts, torch.from_numpy(actions))
        assert_states_equal(ts, _batched(js), "%s step %d" % (name, i))
        ops.append(np.asarray(js.last_op).copy())
        if i % 2:
            js, ts = jclear(js), tclear(ts)
            assert_states_equal(ts, _batched(js), "clear_dead after %d" % i)
    ops = np.stack(ops)
    assert (ops == OP_COLLIDE).any()
    if name.startswith("pursuit"):
        assert (ops == OP_ATTACK).any()


def generate_map(env, map_size, handles):
    """``examples/train_pursuit.py:16-20``."""
    env.add_walls(method="random", n=map_size * map_size * 0.03)
    env.add_agents(handles[0], method="random", n=map_size * map_size * 0.0125)
    env.add_agents(handles[1], method="random", n=map_size * map_size * 0.025)


@pytest.mark.parametrize("route", ["quad", "sort"])
def test_pursuit_gridworld_matches_jax(route, monkeypatch):
    """``GridWorld("pursuit", map_size=48)`` with train_pursuit's map, 10
    steps of get_observation, set_action, step, get_reward and clear_dead:
    every return value and the whole state after every call."""
    make = _routes(route, monkeypatch)
    monkeypatch.setattr(tengine, "make_step", make)
    env = dual("pursuit", map_size=48)
    assert env.t._step_fn.route == tengine._Route(grid=True,
                                                  quad=route == "quad")
    handles = env.get_handles()
    env.set_seed(4)
    env.reset()
    generate_map(env, 48, handles)
    assert [env.get_num(h) for h in handles] == [28, 57]
    rng = np.random.RandomState(4)
    rewarded = 0
    for _ in range(10):
        for h in handles:
            env.get_observation(h)
            env.set_action(h, rng.randint(0, env.get_action_space(h)[0],
                                          env.get_num(h)).astype(np.int32))
        env.step()
        rewarded += sum(int((env.get_reward(h) > 0).sum()) for h in handles)
        env.clear_dead()
    assert rewarded > 0  # predators caught prey


def test_vec_pursuit_past_the_batch_cap_matches_jax(monkeypatch):
    """A lockstep pursuit batch (B=2) past ``QUAD_MAX_AGENTS``, shrunk to 16
    in both packages: the JAX package leaves the gridless path for the grid
    path's sort branches, and so does the port; reset, 5 transitions and
    observe_all equal."""
    monkeypatch.setattr(jap, "QUAD_MAX_AGENTS", 16)
    monkeypatch.setattr(tap, "QUAD_MAX_AGENTS", 16)
    placements, walls = tpursuit.layout(24, seed=3, wall_frac=0.03)
    p = Pair("pursuit", 24, [7, 14], 2, placements=placements, walls=walls)
    assert p.spec.n_agents_cap == 21
    assert p.tv._step.route == tengine._Route(grid=True, quad=False)
    jkey, tkey = key_pair(8)
    js, ts = p.reset(jkey), p.tv.reset(tkey)
    assert_states_equal(ts, js, "reset")
    jkey, tkey = key_pair(9)
    x0 = np.asarray(js.x)
    for step in range(5):
        tag = "step %d" % step
        assert_obs_equal(p.tv.observe_all(ts), p.observe_all(js), p.spec, tag)
        (jkey, jsub), (tkey, tsub) = split_pair(jkey, tkey)
        ja, ta = p.random_actions(jsub), p.tv.random_actions(tsub)
        js, jr, _, jd = p.transition(js, ja)
        ts, tr, _, td = p.tv.transition(ts, ta)
        assert_states_equal(ts, js, tag)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (np.asarray(js.x) != x0).any()
    # the grid the port kept equals a rebuild from the final positions
    grid = -np.ones_like(np.asarray(js.cell_slot))
    for b in range(2):
        for s in range(p.spec.n_agents_cap):
            if np.asarray(js.active)[b, s] and not np.asarray(js.dead)[b, s]:
                x, y = int(js.x[b, s]), int(js.y[b, s])
                grid[b, y:y + p.spec.s_length[s],
                     x:x + p.spec.s_width[s]] = s
    np.testing.assert_array_equal(ts.cell_slot.numpy(), grid)


def test_pursuit_golden_scenario_matches_jax():
    """The golden ``pursuit`` scenario (2x2 predators, map 24) through
    ``tests/golden/scenarios.py``'s ``run_scenario`` on both packages, every
    call and the whole state compared (see test_torch_port_food_absorb)."""
    _, env, seen = run_dual_scenario("pursuit")
    assert env.t._step_fn.route == tengine._Route(grid=True, quad=True)
    assert env.t.spec.max_body_w == 2 and seen.collides > 0
