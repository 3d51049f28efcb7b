"""``GridWorld("double_attack")`` of the port against the JAX package's, call
for call: the golden scenario's layout (``tests/golden/scenarios.py``:
map 20, a 3x3 deer grid at stride 3 and a 4x4 tiger grid at stride 2)
plus random walls, deer acting at random, each tiger with a deer in its
attack range attacking the first one (through the ``view2attack`` table, as
trained tigers do) and the rest at random; ``clear_dead`` every step.  Both
on the pair kernels and on the sort branches (the JAX package pinned with
``MAGENT_ATTACK_PATH=sort``, the port's step built on the route
``quad=False``).  The rule compiles to ``PairSharedObjectRule`` and fires.
Also ``tests/test_rules_inaline.py``'s flow (an 'all' subject:
``GeneralRule``) through both packages' GridWorld, cap growth through
recompiled rules, and the routes of train_tiger's maps 500 and 400.  Every
return value and the whole state are compared exactly after every call."""

import numpy as np
import pytest

import magent_tpu_torch as tmagent
from magent_tpu_torch.core import engine as tengine
from magent_tpu_torch.core import rules as trules

from test_torch_port_gridworld import dual

N_STEPS = 10
N_WALLS = 15


def _grid(x0, y0, nx, ny, stride):
    return [[x0 + i * stride, y0 + j * stride, 0]
            for i in range(nx) for j in range(ny)]


def tiger_actions(env, tigers, deer, view, rng):
    """Attack the first deer (row-major) in attack range through the
    ``view2attack`` table, else a random action."""
    base, v2a = env.get_view2attack(tigers)
    sp = env.spec
    ch = int(sp.channel_perm(tigers.value)[sp.group2channel(deer.value)])
    flat = ((view[..., ch] > 0.5) & (v2a[None] != -1)).reshape(len(view), -1)
    acts = rng.randint(0, env.get_action_space(tigers)[0], len(view))
    found = flat.any(1)
    acts[found] = base + v2a.reshape(-1)[flat.argmax(1)[found]]
    return acts.astype(np.int32)


def _play(env, seed):
    """The golden layout, N_STEPS steps; returns the tigers' rewards."""
    deer, tigers = env.get_handles()
    env.set_seed(seed)
    env.reset()
    env.add_agents(deer, method="custom", pos=_grid(6, 6, 3, 3, 3))
    env.add_agents(tigers, method="custom", pos=_grid(5, 5, 4, 4, 2))
    env.add_walls(method="random", n=N_WALLS)
    rng = np.random.RandomState(seed)
    paid = []
    for _ in range(N_STEPS):
        view, _ = env.get_observation(deer)
        env.set_action(deer, rng.randint(0, env.get_action_space(deer)[0],
                                          len(view)).astype(np.int32))
        view, _ = env.get_observation(tigers)
        env.set_action(tigers, tiger_actions(env, tigers, deer, view, rng))
        env.step()
        env.get_reward(deer)
        paid.append(env.get_reward(tigers))
        env.clear_dead()
    return paid


@pytest.mark.parametrize("route", ["quad", "sort"])
@pytest.mark.parametrize("seed", [0, 1])
def test_double_attack_gridworld_matches_jax(route, seed, monkeypatch):
    if route == "sort":
        monkeypatch.setenv("MAGENT_ATTACK_PATH", "sort")
        monkeypatch.setattr(tengine, "make_step", lambda sp: (
            tengine._build_step(sp, tengine._Route(grid=True, quad=False))))
    env = dual("double_attack", map_size=20)
    assert env.t._step_fn.route == tengine._Route(grid=True,
                                                  quad=route == "quad")
    plans = env.t.spec.compiled_rules()
    assert [type(p) for p in plans] == [trules.PairSharedObjectRule]
    assert [type(p).__name__ for p in env.j.spec.compiled_rules()] == [
        "PairSharedObjectRule"]
    paid = _play(env, seed)
    # tigers earn nothing but the rule: 2 (k - 1) for k tigers on a deer
    fired = [r[r > 0] for r in paid]
    assert sum(len(f) for f in fired) >= 2
    assert all((f == np.round(f)).all() and (f % 2 == 0).all()
               for f in fired)


def test_double_attack_caps_grow_through_recompiles():
    """The stateful world grows its caps by doubling as agents are added;
    each growth recompiles the spec and its rules (new slot offsets)."""
    env = dual("double_attack", map_size=40)
    deer, tigers = env.get_handles()
    env.reset()
    env.add_agents(deer, method="random", n=300)
    env.add_agents(tigers, method="random", n=60)
    env.add_agents(deer, method="random", n=300)
    assert [g.cap for g in env.t.spec.groups] == [1024, 256]
    assert env.t.spec.groups[1].offset == 1024
    rng = np.random.RandomState(0)
    for _ in range(3):
        view, _ = env.get_observation(deer)
        env.set_action(deer, rng.randint(0, env.get_action_space(deer)[0],
                                          len(view)).astype(np.int32))
        view, _ = env.get_observation(tigers)
        env.set_action(tigers, tiger_actions(env, tigers, deer, view, rng))
        env.step()
        env.get_reward(tigers)
        env.clear_dead()


def _inaline_config(gw):
    cfg = gw.Config()
    cfg.set({"map_width": 16, "map_height": 16})
    t = cfg.register_agent_type(
        "t", {'width': 1, 'length': 1, 'hp': 1, 'speed': 1,
              'view_range': gw.CircleRange(2),
              'attack_range': gw.CircleRange(0)})
    g = cfg.add_group(t)
    sym = gw.AgentSymbol(g, index='all')
    cfg.add_reward_rule(gw.Event(sym, 'in_a_line'), receiver=sym, value=1)
    return cfg


def test_in_a_line_matches_jax():
    """``test_rules_inaline.py``'s flow: a contiguous column pays the group
    reward to every member, a broken line pays nothing."""
    env = dual(_inaline_config)
    assert [type(p) for p in env.t.spec.compiled_rules()] == [
        trules.GeneralRule]
    h, = env.get_handles()
    t = env.t.spec.groups[0].type
    stay = next(i for i in range(t.move_range.count)
                if t.move_range.num2delta(i) == (0, 0))
    for pos, paid in (([[4, 4], [4, 5], [4, 6]], True),
                      ([[4, 4], [4, 6], [8, 8]], False)):
        env.reset()
        env.add_agents(h, method="custom", pos=pos)
        env.set_action(h, np.full(3, stay, np.int32))
        env.step()
        reward = env.get_reward(h)
        assert ((reward >= 1.0 - 1e-6).all() if paid
                else (reward < 1.0).all()), pos


def test_double_attack_is_a_port_config():
    """The port's own copy of the config, importing nothing of JAX."""
    from magent_tpu_torch.builtin.config import double_attack

    assert double_attack.magent is tmagent
    cfg = double_attack.get_config(30)
    assert isinstance(cfg, tmagent.gridworld.Config)


@pytest.mark.parametrize("map_size,caps,obs_route,quad", [
    (500, [16384, 4096], "window_gather_banded", False),
    (400, [8192, 2048], "window_gather", True)])
def test_train_tiger_maps_route_as_jax(map_size, caps, obs_route, quad):
    """train_tiger's map 500 (12,500 deer and 2,500 tigers grow the caps to
    16,384 + 4,096) takes the grid path's sort branches, and its padded
    images (536 rows x 2,945 lanes, 6.31 MB) are above the image budget:
    the banded gather, as the JAX package decides from the same geometry.
    Map 400 (caps 8,192 + 2,048) stays on the pair kernels and
    window_gather."""
    from magent_tpu import spec as jspec
    from magent_tpu.builtin.config import double_attack as jdouble
    from magent_tpu.core import observe as jobserve
    from magent_tpu.ops import attack_prefix as jap

    env = tmagent.GridWorld("double_attack", map_size=map_size, caps=caps,
                            device="cpu")
    A = env.spec.n_agents_cap
    assert [f.route for f in env._observe_fns] == [obs_route] * 2
    assert env._step_fn.route == tengine._Route(grid=True, quad=quad)
    jsp = jspec.compile_spec(jdouble.get_config(map_size), caps)
    Hp, _, lanes, _, _ = jobserve.make_grids(jsp).geometry
    assert (Hp * lanes * 4 > jobserve.VMEM_IMAGE_BUDGET) == (
        obs_route == "window_gather_banded")
    assert (A <= jap.QUAD_MAX_SINGLE) == quad
