"""The port's gridless rect path against the JAX package's: pursuit's 2x2
predators in the lockstep VecGridWorld (map 64, [51, 102], B=16, the
placements of scripts/train_evidence.py), with and without interior walls,
and the mixed 2x2 / 1x3 config of tests/test_gridless.py:362 (max_body 3).
Resets, raw steps, 6-transition trajectories and observe_all are compared
on equal states, actions and keys: every state field exactly, views and
features as in _torch_port_cases.assert_obs_equal.  Also the routes:
the port follows the JAX package's for every slot count and batch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magent_tpu as jmagent
from magent_tpu.core import engine as jengine

import magent_tpu_torch as tmagent
from magent_tpu_torch import spec as tspec
from magent_tpu_torch.builtin.config import pursuit as tpursuit
from magent_tpu_torch.core import engine as tengine
from magent_tpu_torch.ops import attack_prefix as tap
from magent_tpu_torch.ops import window_gather as twg
from magent_tpu_torch.parallel import VecGridWorld
from magent_tpu_torch.spec import OP_ATTACK, OP_COLLIDE, OP_KILL

from _torch_port_cases import (CONFIGS, Pair, arrays_of, assert_obs_equal,
                               assert_states_equal, biased_actions, jax_state,
                               key_pair, perturb, port_state, split_pair)

MAP, CAPS, B = 64, [51, 102], 16
N_TRANSITIONS = 6


def _mixed_config(magent):
    """tests/test_gridless.py:362's config in either package: 2x2 blocks and
    1x3 snakes (max_body 3, a non-power-of-two key stride)."""
    def get_config(map_size):
        gw = magent.gridworld
        cfg = gw.Config()
        cfg.set({"map_width": map_size, "map_height": map_size})
        block = cfg.register_agent_type(
            "block", {'width': 2, 'length': 2, 'hp': 1, 'speed': 1,
                      'view_range': gw.CircleRange(4),
                      'attack_range': gw.CircleRange(2)})
        snake = cfg.register_agent_type(
            "snake", {'width': 1, 'length': 3, 'hp': 1, 'speed': 2,
                      'view_range': gw.CircleRange(4),
                      'attack_range': gw.CircleRange(1)})
        g0 = cfg.add_group(block)
        g1 = cfg.add_group(snake)
        a = gw.AgentSymbol(g0, index='any')
        b = gw.AgentSymbol(g1, index='any')
        cfg.add_reward_rule(gw.Event(a, 'attack', b), receiver=[a, b],
                            value=[1, -1])
        return cfg
    return get_config


def _mixed_placements():
    """The placements of tests/test_gridless.py:387-400 (seed 11)."""
    rng = np.random.RandomState(11)
    taken = set()
    blocks, snakes = [], []
    while len(blocks) < 12:
        x, y = int(rng.randint(1, 22)), int(rng.randint(1, 22))
        cells = [(x + dx, y + dy) for dx in range(2) for dy in range(2)]
        if not any(c in taken for c in cells):
            taken.update(cells)
            blocks.append([x, y, 0])
    while len(snakes) < 12:
        x, y = int(rng.randint(1, 22)), int(rng.randint(1, 21))
        cells = [(x, y + dy) for dy in range(3)]
        if not any(c in taken for c in cells):
            taken.update(cells)
            snakes.append([x, y, 0])
    return [blocks, snakes]


def _minimap_pursuit(get_config):
    def minimap(map_size):
        cfg = get_config(map_size)
        cfg.set({"minimap_mode": True})
        return cfg
    return minimap


# name -> (Pair constructor arguments); "walls" adds 3% interior walls
SETUPS = {
    "pursuit": lambda: Pair("pursuit", MAP, CAPS, B,
                            placements=tpursuit.layout(MAP)[0]),
    "pursuit_walls": lambda: Pair("pursuit", MAP, CAPS, B,
                                  *tpursuit.layout(MAP, wall_frac=0.03)),
    "mixed": lambda: Pair((_mixed_config(tmagent), _mixed_config(jmagent)),
                          26, [12, 12], 3, placements=_mixed_placements()),
}


@pytest.fixture(scope="module", params=sorted(SETUPS))
def pair(request):
    p = SETUPS[request.param]()
    p.name = request.param
    return p


def test_route_is_gridless_rect(pair):
    step = pair.tv._step
    assert step.route == tengine._Route(grid=False, quad=True)
    assert pair.spec.max_body_w == (3 if pair.name == "mixed" else 2)


def test_reset_matches_jax(pair):
    """Explicit multi-cell placements: the reset equals the JAX reset in
    every field, cell_slot holding each whole body rect."""
    jkey, tkey = key_pair(1)
    ts = pair.tv.reset(tkey)
    assert_states_equal(ts, pair.reset(jkey), "reset")
    spec = pair.spec
    cells = (ts.cell_slot[0] >= 0).sum().item()
    assert cells == int((spec.s_width * spec.s_length).sum())
    if pair.name == "pursuit_walls":
        assert ts.cell_wall[0].sum().item() == 4 * (MAP - 1) + 122


@pytest.mark.parametrize("seed", [0, 1])
def test_step_matches_jax(pair, seed):
    """One raw step from a perturbed reset (random hp, dead agents): every
    field; pursuit's layout shows attacks and collisions."""
    spec = pair.spec
    jkey, _ = key_pair(seed)
    arrays = perturb(arrays_of(pair.reset(jkey)), spec, seed, dead_frac=0.1)
    actions = biased_actions(spec, pair.tv.n_envs, seed, attack_frac=0.5)
    js = pair.step(jax_state(arrays), jnp.asarray(actions))
    ts = pair.tv.step(port_state(arrays), torch.from_numpy(actions))
    assert_states_equal(ts, js, "seed %d" % seed)
    op = np.asarray(js.last_op)
    assert (op == OP_COLLIDE).sum() > 0
    if pair.name != "mixed":  # the mixed layout is too sparse to promise hits
        # pursuit's predators deal no damage: attacks, never kills
        assert (op == OP_ATTACK).sum() > 0 and (op == OP_KILL).sum() == 0
    if pair.name == "pursuit_walls":
        # the interior walls block moves that the border-only step allows
        free = tengine.make_step(spec, maintain_grid=False, n_envs=B)
        ts_free = free(port_state(arrays), torch.from_numpy(actions))
        assert (ts_free.x != ts.x).any() or (ts_free.y != ts.y).any()
        assert (np.asarray(js.x) != arrays["x"]).any()


def test_trajectory_matches_jax(pair):
    """observe_all -> actions -> transition for 6 steps from one reset key:
    states, rewards, alive and done after every transition, views and
    features before it."""
    jkey, tkey = key_pair(21)
    js, ts = pair.reset(jkey), pair.tv.reset(tkey)
    x0 = np.asarray(js.x)
    jkey, tkey = key_pair(22)
    rewarded = 0
    for step in range(N_TRANSITIONS):
        tag = "step %d" % step
        assert_obs_equal(pair.tv.observe_all(ts), pair.observe_all(js),
                         pair.spec, tag)
        (jkey, jsub), (tkey, tsub) = split_pair(jkey, tkey)
        ja = pair.random_actions(jsub)
        ta = pair.tv.random_actions(tsub)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        js, jr, jal, jd = pair.transition(js, ja)
        ts, tr, tal, td = pair.tv.transition(ts, ta)
        assert_states_equal(ts, js, tag)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tal.numpy(), np.asarray(jal))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        rewarded += int((np.asarray(jr) > 0).sum())
    assert (np.asarray(js.x) != x0).any()  # agents moved
    if pair.name != "mixed":
        assert rewarded > 0  # predators caught prey


def test_observe_with_minimap_matches_jax():
    """Pursuit with minimap_mode on: the scatter minimap of multi-cell
    bodies; the prey's 9x9x7 windows (63 lanes) take window_gather4 with
    the fused minimap epilogue, the predators' 10x10x7 (70 lanes) take
    window_gather and the separate epilogue."""
    port_cfg, jax_cfg = CONFIGS["pursuit"]
    p = Pair((_minimap_pursuit(port_cfg), _minimap_pursuit(jax_cfg)), 32,
             [12, 25], 2, placements=tpursuit.layout(32, seed=3)[0])
    assert [p.spec.view_space(g)[1] * p.spec.n_channel for g in range(2)] \
        == [70, 63]
    jkey, _ = key_pair(5)
    arrays = perturb(arrays_of(p.reset(jkey)), p.spec, 5, dead_frac=0.2)
    rng = np.random.RandomState(5)
    arrays["last_reward"] = rng.normal(size=arrays["last_reward"].shape).astype(
        np.float32)
    t_obs = p.tv.observe_all(port_state(arrays))
    assert_obs_equal(t_obs, p.observe_all(jax_state(arrays)), p.spec,
                     "minimap")
    assert t_obs[1][0].numpy().max() >= 1.0  # the self mark


def test_observe_past_packed_positions_matches_jax():
    """A map whose padded image has more than 2**21 cells (pursuit with
    minimap_mode at map 1416): the prey's windows, which window_gather4
    serves on smaller maps, take window_gather and the separate epilogue,
    since the packed positions tl * 1024 + self_cell of the bottom rows
    would overflow int32.  Agents at the top and the bottom of the map see
    what the JAX package's views show."""
    M = 1416
    port_cfg, jax_cfg = CONFIGS["pursuit"]
    preds = [[x, y, 0] for y in (2, M - 3) for x in (1, 4)]
    prey = [[x, y, 0] for y in (1, M - 2) for x in range(8, 12)]
    p = Pair((_minimap_pursuit(port_cfg), _minimap_pursuit(jax_cfg)), M,
             [4, 8], 1, placements=[preds, prey])
    Hp, Wp = p.tv._grids.geometry[:2]
    assert Hp * Wp > twg.PACKED_CELLS and M * Wp > twg.PACKED_CELLS
    assert p.spec.view_space(1)[1] * p.spec.n_channel == 63
    jkey, _ = key_pair(6)
    arrays = perturb(arrays_of(p.reset(jkey)), p.spec, 6, dead_frac=0.25)
    t_obs = p.tv.observe_all(port_state(arrays))
    assert_obs_equal(t_obs, p.observe_all(jax_state(arrays)), p.spec,
                     "map %d" % M)
    live = ~arrays["dead"][0, 4:]
    assert (t_obs[1][0][0].flatten(1).amax(1).numpy()[live] >= 1.0).all()


def test_wall_rect_code_matches_jax(pair):
    """The packed per-body-size wall-overlap grid and its slot bits."""
    rng = np.random.RandomState(2)
    H, W = pair.spec.height, pair.spec.width
    wall = rng.uniform(size=(H, W)) < 0.05
    got = tengine._wall_rect_code(pair.spec, wall)
    want = jengine._wall_rect_code(pair.jv.spec, wall)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_interior_walls_gridless_1x1_matches_jax():
    """Interior walls also reach the 1x1 gridless move: battle with 10%
    walls, three lockstep steps."""
    rng = np.random.RandomState(4)
    cells = rng.permutation(18 * 18)
    walls = np.stack([cells[:32] % 18 + 1, cells[:32] // 18 + 1], 1)
    xy = np.stack([cells[32:] % 18 + 1, cells[32:] // 18 + 1], 1)
    p = Pair("battle", 20, [40, 40], 2, placements=[xy[:40], xy[40:80]],
             walls=walls)
    assert p.tv._step.route == tengine._Route(grid=False, quad=True)
    jkey, tkey = key_pair(3)
    js, ts = p.reset(jkey), p.tv.reset(tkey)
    assert_states_equal(ts, js, "reset")
    for step in range(3):
        actions = biased_actions(p.spec, 2, 40 + step, attack_frac=0.2)
        js = p.step(js, jnp.asarray(actions))
        ts = p.tv.step(ts, torch.from_numpy(actions))
        assert_states_equal(ts, js, "step %d" % step)


def _rect_spec(A):
    """A pursuit spec with A slots (map 2048, so every cap fits)."""
    return tspec.compile_spec(tpursuit.get_config(2048), [A // 3, A - A // 3])


# "Queue 1 item 7" (the ROADMAP item that ported it) names the grid path's
# sort branches, which the JAX package takes past the caps
_ROUTES = {"quad": tengine._Route(grid=False, quad=True),
           "seg": tengine._Route(grid=False, quad=True, seg=True),
           "Queue 1 item 7": tengine._Route(grid=True, quad=False)}


@pytest.mark.parametrize("A,n_envs,expect", [
    (tap.QUAD_MAX_SINGLE - 1, 1, "quad"),
    (tap.QUAD_MAX_SINGLE, 1, "seg"),
    (tengine.SEG_DEFAULT_MAX, 1, "seg"),
    (tengine.SEG_DEFAULT_MAX + 1, 1, "Queue 1 item 7"),
    (tap.QUAD_MAX_AGENTS, 4, "quad"),
    (tap.QUAD_MAX_AGENTS + 1, 4, "Queue 1 item 7"),
])
def test_rect_route_raises_where_not_ported(A, n_envs, expect):
    """The JAX package's routes for multi-cell specs (engine.py:169-196,
    :1004-1011): gridless pair sweeps up to the quad cap, y-segmented sweeps
    for one world from QUAD_MAX_SINGLE (inclusive) to SEG_DEFAULT_MAX, the
    grid path's sort branches beyond.  The port takes all three; nothing
    raises any more."""
    spec = _rect_spec(A)
    step = tengine.make_step(spec, maintain_grid=False, n_envs=n_envs)
    assert step.route == _ROUTES[expect]


def test_rect_grid_path_raises():
    """Multi-cell bodies on the grid path build, the stateful GridWorld's
    included; random placement of multi-cell bodies in VecGridWorld still
    raises (it places 1x1 bodies only, as the JAX package's does)."""
    spec = _rect_spec(96)
    assert tengine.make_step(spec, maintain_grid=True).route == \
        tengine._Route(grid=True, quad=True)
    env = tmagent.GridWorld("pursuit", map_size=32, device="cpu")
    assert env._step_fn.route == tengine._Route(grid=True, quad=True)
    with pytest.raises(ValueError, match="explicit placements"):
        VecGridWorld(tpursuit.get_config(32), [4, 8], 2, device="cpu")

