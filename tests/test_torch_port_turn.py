"""Turn mode in the port against the JAX package, on the CPU: the geometry
transforms, the engine's turn phase inside the step (10 chained steps from
one placed state on the pair-kernel route and on the sort branches, with
food mode on, every state field exact), ``VecGridWorld``'s turn-mode reset
(the placements' facings, and random facings from ``fold_in(key, 1)``) and
a B=3 trajectory (the golden ``turn_bodies`` scenario and a ``dqn`` step:
``test_torch_port_turn_world.py``).

On the CPU the JAX package observes turn mode through its per-direction
gather (``_make_observe_rotating_xla``), which reads the hp unquantized;
the port takes the stacked-rotations route there as on the card, whose
packed cells quantize the hp to 2**-23 of its maximum.  So views are held
to the JAX package's own tolerance between those two routes (atol 1e-6,
``tests/test_observe_parity.py:284-289``) wherever the port runs its
default route, and exactly wherever the port is put on its per-direction
route (both observation budgets shrunk to 0).  The stacked and banded
routes are held exactly against the JAX kernel route in
``test_torch_port_turn_observe.py``, the other observation cases in
``test_torch_port_turn_routes.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magent_tpu as jmagent
from magent_tpu import gridworld as jgw
from magent_tpu.core import engine as jengine
from magent_tpu.core import geometry as jgeo

from magent_tpu_torch import gridworld as tgw
from magent_tpu_torch import spec as tspec
from magent_tpu_torch.core import engine as tengine
from magent_tpu_torch.core import geometry as tgeo
from magent_tpu_torch.core import observe as tobserve
from magent_tpu_torch.core.state import state_from_numpy
from magent_tpu_torch.spec import OP_ATTACK, OP_COLLIDE, OP_KILL

from _torch_port_cases import (Pair, arrays_of, assert_states_equal,
                               key_pair, split_pair)

MAP = 20
# the interior wall of tests/test_observe_parity.py:_turn_env
WALLS = [[10, y] for y in range(8, 14)]
# (x, y, facing) of the two groups there: every facing in each group
PLACEMENTS = [
    [[4 + 3 * i, 5 + 3 * j, (i + j) % 4] for i in range(3) for j in range(3)
     if [4 + 3 * i, 5 + 3 * j] not in WALLS],
    [[13 + 2 * i, 6 + 3 * j, (i + 3 * j) % 4] for i in range(3)
     for j in range(3)],
]
# a packed layout for the step: rows of 1x2 bodies facing NORTH or SOUTH
# side by side (a turn needs a neighbour's cell, so most are blocked until
# the rows thin out) and rows of 1x1 bodies of every facing between them
DENSE = [
    [[3 + i, 3 + 3 * j, 1 + 2 * ((i + j) % 2)] for i in range(6)
     for j in range(3)],
    [[3 + i, 5 + 3 * j, (i + j) % 4] for i in range(6) for j in range(2)],
]
# the JAX package's tolerance between its two turn-mode routes
ROUTE_ATOL = 1e-6
N_STEPS = 10


def turn_config(gw, map_size=MAP, minimap=False, food=False, long=True):
    """``tests/test_observe_parity.py:_turn_env``'s config in either
    package (``gw`` its gridworld module): 1x2 bodies (1x1 with
    ``long=False``) that attack 1x1 ones, turn mode; with ``food`` the
    kills drop food and both types eat."""
    cfg = gw.Config()
    cfg.set({"map_width": map_size, "map_height": map_size,
             "turn_mode": True, "embedding_size": 4,
             "minimap_mode": minimap, "food_mode": food})
    eat = {'food_supply': 3, 'eat_ability': 2} if food else {}
    big = cfg.register_agent_type(
        "big", dict({'width': 1, 'length': 2 if long else 1, 'hp': 6,
                     'speed': 1, 'view_range': gw.CircleRange(3),
                     'attack_range': gw.CircleRange(2), 'damage': 1}, **eat))
    small = cfg.register_agent_type(
        "small", dict({'width': 1, 'length': 1, 'hp': 4, 'speed': 1,
                       'view_range': gw.CircleRange(2),
                       'attack_range': gw.CircleRange(1), 'damage': 1},
                      **eat))
    g0 = cfg.add_group(big)
    g1 = cfg.add_group(small)
    a, b = gw.AgentSymbol(g0, 'any'), gw.AgentSymbol(g1, 'any')
    cfg.add_reward_rule(gw.Event(a, 'attack', b), receiver=a, value=0.3)
    return cfg


def jax_turn_world(caps=32, seed=0, placements=PLACEMENTS, **kw):
    """A JAX GridWorld of :func:`turn_config` with the wall and
    ``placements``, its hp lowered to random fractions (kills within a few
    steps, and hp values the packed cells must round) -> (env, port
    spec)."""
    env = jmagent.GridWorld(turn_config(jgw, **kw), caps=caps)
    env.reset()
    env.add_walls(method="custom", pos=WALLS)
    for h, pos in zip(env.get_handles(), placements):
        env.add_agents(h, method="custom", pos=pos)
    rng = np.random.RandomState(seed)
    hp = np.asarray(env.state.hp) * (0.2 + 0.6 * rng.uniform(
        size=env.spec.n_agents_cap))
    env.state = env.state.replace(hp=jnp.asarray(hp.astype(np.float32)))
    return env, tspec.compile_spec(turn_config(tgw, **kw), env._caps)


def batched(js):
    return {k: v[None] for k, v in arrays_of(js).items()}


def turn_actions(spec, B, seed, turn_frac=0.35, attack_frac=0.35):
    """Per-slot actions drawn with numpy: both turn actions with
    ``turn_frac``, attacks with ``attack_frac``, moves otherwise, and a few
    out-of-range no-ops."""
    rng = np.random.RandomState(seed)
    A = spec.n_agents_cap
    turn = spec.s_turn_base[None] + rng.randint(0, 2, (B, A))
    n_att = spec.s_n_action - spec.s_attack_base
    att = spec.s_attack_base[None] + rng.randint(0, 1 << 20, (B, A)) % n_att
    move = rng.randint(0, 1 << 20, (B, A)) % spec.s_turn_base[None]
    u = rng.uniform(size=(B, A))
    acts = np.where(u < turn_frac, turn,
                    np.where(u < turn_frac + attack_frac, att, move))
    acts = np.where(rng.uniform(size=(B, A)) < 0.03, spec.s_n_action, acts)
    return acts.astype(np.int32)


# ------------------------------------------------------------------ geometry
@pytest.mark.parametrize("w,l", [(1, 1), (1, 2), (2, 2), (2, 3)])
def test_real_to_save_round_trips_match_jax(w, l):
    """``real_to_save`` and ``save_to_real`` equal the JAX package's for
    every facing, and undo each other."""
    rng = np.random.RandomState(w * 10 + l)
    x = rng.randint(0, 50, 64).astype(np.int32)
    y = rng.randint(0, 50, 64).astype(np.int32)
    for d in range(4):
        dirs = np.full(64, d, np.int32)
        tx, ty, td = (torch.from_numpy(a) for a in (x, y, dirs))
        for tf, jf in ((tgeo.real_to_save, jgeo.real_to_save),
                       (tgeo.save_to_real, jgeo.save_to_real)):
            got = tf(tx, ty, td, w, l)
            want = jf(jnp.asarray(x), jnp.asarray(y), jnp.asarray(dirs), w, l)
            for g, wnt in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
        sx, sy = tgeo.real_to_save(*tgeo.save_to_real(tx, ty, td, w, l), td,
                                   w, l)
        assert torch.equal(sx, tx) and torch.equal(sy, ty)


# ---------------------------------------------------------------- the step
@pytest.mark.parametrize("food", [False, True], ids=["plain", "food"])
@pytest.mark.parametrize("route", ["quad", "sort"])
def test_turn_step_matches_jax(route, food, monkeypatch):
    """10 chained steps with turns, attacks and moves, clear_dead every
    third: every state field exact after every call.  Turns that commit,
    turns blocked by walls, bodies and food (or claimed by a lower slot),
    collisions and attacks all happen."""
    if route == "sort":
        monkeypatch.setenv("MAGENT_ATTACK_PATH", "sort")
    env, sp = jax_turn_world(seed=1 + food, placements=DENSE, food=food)
    jstep = jax.jit(jengine.make_step(env.spec))
    jclear = jax.jit(jengine.make_clear_dead(env.spec))
    tstep = (tengine.make_step(sp) if route == "quad" else
             tengine._build_step(sp, tengine._Route(grid=True, quad=False)))
    assert tstep.route == tengine._Route(grid=True, quad=route == "quad")
    tclear = tengine.make_clear_dead(sp)
    js, ts = env.state, state_from_numpy(batched(env.state), "cpu")
    turned = blocked = 0
    ops, food_cells = [], 0
    for i in range(N_STEPS):
        actions = turn_actions(sp, 1, 7 * i + food)
        d0 = np.asarray(js.dir)
        js = jstep(js, jnp.asarray(actions[0]))
        ts = tstep(ts, torch.from_numpy(actions))
        assert_states_equal(ts, batched(js), "%s step %d" % (route, i))
        live = np.asarray(js.active & ~js.dead)
        is_turn = live & (actions[0] >= sp.s_turn_base) & (
            actions[0] < sp.s_attack_base)
        turned += int((is_turn & (np.asarray(js.dir) != d0)).sum())
        blocked += int((is_turn & (np.asarray(js.dir) == d0)).sum())
        ops.append(np.asarray(js.last_op).copy())
        food_cells += int((np.asarray(js.cell_food) >= 0).sum())
        if i % 3 == 2:
            js, ts = jclear(js), tclear(ts)
            assert_states_equal(ts, batched(js), "clear_dead after %d" % i)
    ops = np.stack(ops)
    assert turned > 10 and blocked > 0
    assert (ops == OP_ATTACK).any() and (ops == OP_COLLIDE).any()
    assert (ops == OP_KILL).any()
    assert sorted(np.unique(np.asarray(js.dir)[live])) == [0, 1, 2, 3]
    if food:
        assert food_cells > 0


def test_turn_spec_takes_the_grid_path():
    """A turn spec steps on the grid path even where the caller asks for
    the gridless one, and a gridless route is refused."""
    env, sp = jax_turn_world()
    for grid in (True, False):
        assert tengine.make_step(sp, maintain_grid=grid, n_envs=4).route == \
            tengine._Route(grid=True, quad=True)
    with pytest.raises(ValueError, match="grid path only"):
        tengine._build_step(sp, tengine._Route(grid=False, quad=True))


# ------------------------------------------------------------ VecGridWorld
def _pair(B, long=True, placements=PLACEMENTS):
    cfgs = (lambda m: turn_config(tgw, m, long=long),
            lambda m: turn_config(jgw, m, long=long))
    caps = [len(p) for p in placements] if placements else [12, 12]
    return Pair(cfgs, MAP, caps, B, placements=placements, walls=WALLS)


@pytest.mark.parametrize("placed", [True, False], ids=["placements",
                                                        "random"])
def test_vec_turn_reset_matches_jax(placed):
    """The reset keeps the placements' facings and fills each body's rect
    in its facing's footprint; random placement (1x1 bodies) draws the
    facings from ``fold_in(key, 1)`` of each env's placement key."""
    p = _pair(3, long=placed, placements=PLACEMENTS if placed else None)
    for seed in (0, 3):
        jkey, tkey = key_pair(seed)
        js, ts = p.reset(jkey), p.tv.reset(tkey)
        assert_states_equal(ts, js, "reset %d" % seed)
        dirs = ts.dir.numpy()
        assert sorted(np.unique(dirs)) == [0, 1, 2, 3]
        if not placed:  # facings differ across the envs
            assert (dirs[0] != dirs[1]).any()


def test_vec_turn_transition_matches_jax():
    """B=3, 5 transitions from one reset: states, rewards and done exact;
    the per-direction route's views and features exact, the default
    (stacked) route's views within ROUTE_ATOL and its features exact."""
    p = _pair(3)
    assert p.tv._grids is None
    assert [o.route for o in p.tv._observe] == ["window_gather"] * 2
    dirs_obs = [tobserve._make_observe_dirs(p.spec, g, torch.float32)
                for g in range(2)]
    jkey, tkey = key_pair(4)
    js, ts = p.reset(jkey), p.tv.reset(tkey)
    jkey, tkey = key_pair(5)
    d0 = ts.dir.clone()
    for step in range(5):
        tag = "step %d" % step
        jobs = p.observe_all(js)
        for g, ((tv, tf), (jv, jf)) in enumerate(zip(p.tv.observe_all(ts),
                                                     jobs)):
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       atol=ROUTE_ATOL, rtol=0, err_msg=tag)
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
            dv, df = dirs_obs[g](ts)
            np.testing.assert_array_equal(dv.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(df.numpy(), np.asarray(jf))
        (jkey, jsub), (tkey, tsub) = split_pair(jkey, tkey)
        ja, ta = p.random_actions(jsub), p.tv.random_actions(tsub)
        js, jr, _, jd = p.transition(js, ja)
        ts, tr, _, td = p.tv.transition(ts, ta)
        assert_states_equal(ts, js, tag)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (ts.dir != d0).any()
