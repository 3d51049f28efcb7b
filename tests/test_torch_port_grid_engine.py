"""The port's grid-path step and clear_dead against the JAX package's, on
one state carried across with ``state_from_numpy``: battle (attacks, kills,
contested and blocked moves) and forest with interior walls (starving
tigers, wall-blocked moves).  Every state field is compared exactly,
``cell_slot`` included, over several chained steps; the step is integer
logic plus the same f32 elementwise ops in the same order (the damages of
both configs sum exactly in any order).  The sort branches (A above the
quad cap) are held against the JAX package under
``MAGENT_ATTACK_PATH=sort``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magent_tpu as jmagent
from magent_tpu.core import engine as jengine

from magent_tpu_torch import spec as tspec
from magent_tpu_torch.core import engine as tengine
from magent_tpu_torch.spec import OP_ATTACK, OP_COLLIDE, OP_KILL

from _torch_port_cases import arrays_of, assert_states_equal, biased_actions

N_STEPS = 6
SETUPS = {
    # name: (config, map size, caps, agents per group, interior walls)
    "battle": ("battle", 16, 64, 40, 0),
    "forest": ("forest", 16, 64, 40, 24),
}


def _jax_world(name, seed):
    """A JAX GridWorld placed with the host LCG: interior walls first, then
    random agents; hp lowered so kills and starvation happen within a few
    steps."""
    cfg, map_size, caps, n, n_walls = SETUPS[name]
    env = jmagent.GridWorld(cfg, map_size=map_size, caps=caps)
    env.set_seed(seed)
    env.reset()
    if n_walls:
        env.add_walls(method="random", n=n_walls)
    for h in env.get_handles():
        env.add_agents(h, method="random", n=n)
    rng = np.random.RandomState(seed)
    hp_max = np.asarray(env.spec.s_hp_max)
    hp = np.asarray(env.state.hp) * (0.15 + 0.5 * rng.uniform(size=hp_max.shape))
    env.state = env.state.replace(hp=jnp.asarray(hp.astype(np.float32)))
    return env


def _batched(js):
    """JAX single-world state -> numpy arrays with a leading env axis."""
    return {k: v[None] for k, v in arrays_of(js).items()}


def _port_state(js):
    from magent_tpu_torch.core.state import state_from_numpy

    return state_from_numpy(_batched(js), "cpu")


def _port_spec(name, env):
    """The port's spec of the JAX world's config and capacities."""
    mod = importlib.import_module("magent_tpu_torch.builtin.config." + name)
    return tspec.compile_spec(mod.get_config(SETUPS[name][1]), env._caps)


def _run_pair(name, seed, port_route=None, clear_every=0):
    """Step the same state in both packages; compare after every step (and
    after every clear_dead).  Returns the JAX ops seen, for coverage."""
    env = _jax_world(name, seed)
    jstep = jax.jit(jengine.make_step(env.spec))
    jclear = jax.jit(jengine.make_clear_dead(env.spec))
    sp = _port_spec(name, env)
    if port_route is None:
        tstep = tengine.make_step(sp)
    else:
        tstep = tengine._build_step(sp, port_route)
    tclear = tengine.make_clear_dead(sp)
    js, ts = env.state, _port_state(env.state)
    assert_states_equal(ts, _batched(js), "carried")
    ops = []
    for i in range(N_STEPS):
        actions = biased_actions(sp, 1, 100 * seed + i)
        js = jstep(js, jnp.asarray(actions[0]))
        ts = tstep(ts, torch.from_numpy(actions))
        assert_states_equal(ts, _batched(js), "%s seed %d step %d" % (name, seed, i))
        ops.append(np.asarray(js.last_op).copy())
        if clear_every and i % clear_every == clear_every - 1:
            js, ts = jclear(js), tclear(ts)
            assert_states_equal(ts, _batched(js), "clear_dead after %d" % i)
    return np.stack(ops)


@pytest.mark.parametrize("name", sorted(SETUPS))
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_step_matches_jax(name, seed):
    ops = _run_pair(name, seed, clear_every=2)
    if name == "battle":
        # the case reaches every branch of the pairwise attack and claims
        assert (ops == OP_KILL).any() and (ops == OP_ATTACK).any()
        assert (ops == OP_COLLIDE).any()


def test_grid_route_is_quad_within_the_cap():
    """make_step decides the route once, from the spec and n_envs alone."""
    sp = _port_spec("battle", _jax_world("battle", 0))
    assert tengine.make_step(sp).route == tengine._Route(grid=True, quad=True)
    assert tengine.make_step(sp, maintain_grid=False, n_envs=4).route == \
        tengine._Route(grid=False, quad=True)


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_sort_branches_match_jax(name, monkeypatch):
    """The attack sort by (target, priority) with segmented cumsums and the
    claims sort by (cell, slot), held against the JAX package's sort path."""
    monkeypatch.setenv("MAGENT_ATTACK_PATH", "sort")
    ops = _run_pair(name, 2, port_route=tengine._Route(grid=True, quad=False),
                    clear_every=3)
    if name == "battle":
        assert (ops == OP_KILL).any() and (ops == OP_COLLIDE).any()


def test_clear_dead_matches_jax():
    """Stable per-group compaction, reward/op rotation, n_in_group recount
    and the cell_slot remap, on a state with dead agents in both groups."""
    env = _jax_world("battle", 3)
    sp = _port_spec("battle", env)
    rng = np.random.RandomState(3)
    dead = np.asarray(env.state.active) & (rng.uniform(size=sp.n_agents_cap) < 0.3)
    js = env.state.replace(
        dead=jnp.asarray(dead),
        next_reward=jnp.asarray(rng.uniform(size=sp.n_agents_cap).astype(np.float32)),
        last_op=jnp.asarray(np.full(sp.n_agents_cap, OP_ATTACK, np.int32)))
    want = jax.jit(jengine.make_clear_dead(env.spec))(js)
    got = tengine.make_clear_dead(sp)(_port_state(js))
    assert_states_equal(got, _batched(want), "clear_dead")
    assert 0 < int(np.asarray(want.n_in_group).sum()) < int(np.asarray(js.n_in_group).sum())


def test_unported_specs_raise():
    """Food, turn mode and absorb specs build, on the grid path even where
    the caller asks for the gridless one (the JAX package's
    _gridless_capable), and a gridless route is refused for them."""
    from magent_tpu_torch import gridworld as gw

    def config(**kw):
        cfg = gw.Config()
        cfg.set(dict({"map_width": 10, "map_height": 10}, **kw))
        t = cfg.register_agent_type("t", {"width": 1, "length": 1})
        cfg.add_group(t)
        return tspec.compile_spec(cfg, [4])

    for spec in (config(food_mode=True), config(turn_mode=True)):
        for grid in (True, False):
            assert tengine.make_step(spec, maintain_grid=grid).route == \
                tengine._Route(grid=True, quad=True)
        with pytest.raises(ValueError, match="grid path only"):
            tengine._build_step(spec, tengine._Route(grid=False, quad=True))
