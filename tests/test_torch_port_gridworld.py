"""The stateful ``GridWorld`` API of the port against the JAX package's: the
same call sequence goes to ``magent_tpu.GridWorld`` and to
``magent_tpu_torch.GridWorld(device="cpu")``, and every return value and
the whole state (``cell_slot`` included) must agree after every call.
Views are exact except the pooled minimap channels (atol 1e-6, as in
``_torch_port_cases.MINIMAP_ATOL``); everything else is exact."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import magent_tpu as jmagent
from magent_tpu import gridworld as jgw

import magent_tpu_torch as tmagent
from magent_tpu_torch import gridworld as tgw

from _torch_port_cases import (MINIMAP_ATOL, arrays_of, assert_states_equal,
                               minimap_channels)


def _assert_state(tenv, jenv, tag):
    want = {k: v[None] for k, v in arrays_of(jenv.state).items()}
    assert_states_equal(tenv.state, want, tag)


def _assert_value(got, want, tag, spec=None, group=None):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), tag
        for k, (g, w) in enumerate(zip(got, want)):
            _assert_value(g, w, "%s[%d]" % (tag, k), spec, group)
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), tag
        assert got.dtype == want.dtype and got.shape == want.shape, tag
        if got.ndim != 4 or spec is None:  # all but views: exact
            np.testing.assert_array_equal(got, want, err_msg=tag)
            return
        mm = minimap_channels(spec, group)
        rest = [c for c in range(got.shape[-1]) if c not in mm]
        np.testing.assert_array_equal(got[..., rest], want[..., rest],
                                      err_msg=tag)
        if mm:
            np.testing.assert_allclose(got[..., mm], want[..., mm],
                                       atol=MINIMAP_ATOL, rtol=0, err_msg=tag)
        return
    if hasattr(want, "value"):  # a group handle
        assert got.value == want.value, tag
        return
    assert got == want, (tag, got, want)


class Dual:
    """Forwards every call to a JAX and a port GridWorld and asserts equal
    results and states; returns the port's result."""

    def __init__(self, jenv, tenv, check_state=True):
        self.j, self.t = jenv, tenv
        self.check_state = check_state

    @property
    def spec(self):
        return self.t.spec

    @property
    def state(self):
        return self.t.state

    def __getattr__(self, name):
        jf, tf = getattr(self.j, name), getattr(self.t, name)
        if not callable(jf):
            return tf

        def call(*args, **kwargs):
            want = jf(*args, **kwargs)
            got = tf(*args, **kwargs)
            group = args[0].value if args and hasattr(args[0], "value") else None
            _assert_value(got, want, name, self.t.spec, group)
            if self.check_state:
                _assert_state(self.t, self.j, name)
            return got

        return call


def dual(config, check_state=True, **kwargs):
    """``config``: a builtin name, or ``fn(gridworld_module) -> Config``."""
    if callable(config):
        jenv = jmagent.GridWorld(config(jgw), **kwargs)
        tenv = tmagent.GridWorld(config(tgw), device="cpu", **kwargs)
    else:
        jenv = jmagent.GridWorld(config, **kwargs)
        tenv = tmagent.GridWorld(config, device="cpu", **kwargs)
    return Dual(jenv, tenv, check_state)


def random_round(env, rng, n_steps, clear=True):
    """``n_steps`` of the README loop with numpy-drawn actions."""
    done = False
    for _ in range(n_steps):
        for h in env.get_handles():
            env.get_observation(h)
            env.set_action(h, rng.randint(0, env.get_action_space(h)[0],
                                          env.get_num(h)).astype(np.int32))
        done = env.step()
        for h in env.get_handles():
            env.get_reward(h)
        if clear:
            env.clear_dead()
    return done


def test_placement_and_walls_match_jax():
    """random / custom / fill for walls and agents draw the same cells from
    the host LCG (skipping blocked and out-of-map cells alike)."""
    env = dual("battle", map_size=30)
    h0, h1 = env.get_handles()
    env.set_seed(3)
    env.reset()
    env.add_walls(method="random", n=15)
    env.add_walls(method="custom", pos=[[4, 4], [4, 5], [40, 2], [0, 7]])
    env.add_walls(method="fill", pos=[25, 2], size=[3, 2])
    env.add_agents(h0, method="random", n=20)
    env.add_agents(h1, method="custom", pos=[[10, 10], [12, 10], [4, 4],
                                             [11, 11, 2], [30, 30]])
    env.add_agents(h0, method="fill", pos=[18, 18], size=[4, 3])
    env.add_agents(h1, method="random", n=25)
    env.add_walls(method="custom", pos=[[10, 10]])  # occupied: ignored
    assert env.get_num(h1) == 28
    random_round(env, np.random.RandomState(0), 3)


def test_growth_new_group_and_seed_match_jax():
    """Capacity growth past the caps (slots migrate, the grid is rebuilt),
    a group appended by new_group, and set_seed determinism."""
    env = dual("battle", map_size=40, caps=8)
    h0, h1 = env.get_handles()
    env.reset()
    env.add_agents(h0, method="random", n=6)
    env.add_agents(h1, method="random", n=5)
    env.set_action(h0, np.arange(6, dtype=np.int32))
    env.add_agents(h0, method="random", n=300)  # 8 -> 256 -> 512
    assert env.t.spec.groups[0].cap == 512
    env.add_agents(h1, method="random", n=30)  # 8 -> 256
    h2 = env.new_group("small")
    assert h2.value == 2 and env.get_view_space(h2) == (13, 13, 10)
    env.add_agents(h2, method="random", n=5)
    random_round(env, np.random.RandomState(1), 3)

    positions = []
    for _ in range(2):
        env.set_seed(42)
        env.reset()
        env.add_agents(h0, method="random", n=30)
        positions.append(env.get_pos(h0))
    np.testing.assert_array_equal(positions[0], positions[1])


def test_getters_match_jax():
    env = dual("battle", map_size=24)
    handles = env.get_handles()
    assert [h.value for h in handles] == [0, 1]
    for h in handles:
        env.get_view_space(h)
        env.get_feature_space(h)
        env.get_action_space(h)
        env.get_view2attack(h)
    env.reset()
    for k, h in enumerate(handles):
        env.add_agents(h, method="custom", pos=[
            [x + k, y] for x in range(6, 18, 2) for y in range(6, 18, 2)])
        env.get_mean_info(h)
    random_round(env, np.random.RandomState(2), 3, clear=False)
    for h in handles:
        env.get_agent_id(h)
        env.get_alive(h)
        env.get_pos(h)
        env.get_mean_info(h)
    env.get_both_attack()
    env.get_global_minimap(8, 8)
    env.set_goal(handles[0], "random")
    env.clear_dead()


# ---- the scenarios of tests/test_engine_basic.py, on both packages -------
def _tiny_battle(gw, map_size=16):
    cfg = gw.Config()
    cfg.set({"map_width": map_size, "map_height": map_size})
    cfg.set({"minimap_mode": True, "embedding_size": 10})
    small = cfg.register_agent_type(
        "small",
        {'width': 1, 'length': 1, 'hp': 10, 'speed': 2,
         'view_range': gw.CircleRange(6), 'attack_range': gw.CircleRange(1.5),
         'damage': 2, 'step_recover': 0.1,
         'step_reward': -0.005, 'kill_reward': 5, 'dead_penalty': -0.1,
         'attack_penalty': -0.1})
    g0 = cfg.add_group(small)
    g1 = cfg.add_group(small)
    a = gw.AgentSymbol(g0, index='any')
    b = gw.AgentSymbol(g1, index='any')
    cfg.add_reward_rule(gw.Event(a, 'attack', b), receiver=a, value=0.2)
    cfg.add_reward_rule(gw.Event(b, 'attack', a), receiver=b, value=0.2)
    return cfg


def _starver(gw):
    cfg = gw.Config()
    cfg.set({"map_width": 8, "map_height": 8})
    t = cfg.register_agent_type(
        "t", {'width': 1, 'length': 1, 'hp': 1, 'speed': 1,
              'view_range': gw.CircleRange(2), 'attack_range': gw.CircleRange(0),
              'step_recover': -0.4, 'dead_penalty': -2.0})
    cfg.add_group(t)
    return cfg


def _scenario_add_and_observe(env):
    h0, h1 = env.get_handles()
    env.add_agents(h0, method="custom", pos=[[3, 3], [5, 3]])
    env.add_agents(h1, method="custom", pos=[[3, 5]])
    views, feats = env.get_observation(h0)
    assert views.shape == (2, 13, 13, 7) and feats.shape == (2, 34)
    assert views[0, 6, 6, 1] == 1.0 and views[0, 6, 8, 1] == 1.0
    assert views[0, 8, 6, 4] == 1.0 and views[0, 6, 3, 0] == 1.0
    views1, _ = env.get_observation(h1)
    assert views1[0, 6, 6, 1] == 1.0 and views1[0, 4, 6, 4] == 1.0


def _scenario_move_and_collision(env):
    h0, h1 = env.get_handles()
    env.add_agents(h0, method="custom", pos=[[3, 3], [4, 3]])
    env.add_agents(h1, method="custom", pos=[[10, 10]])
    env.set_action(h0, np.array([7, 7], np.int32))
    env.set_action(h1, np.array([6], np.int32))
    env.step()
    pos = env.get_pos(h0)
    assert list(pos[1]) == [5, 3] and list(pos[0]) == [3, 3]
    env.clear_dead()


def _scenario_attack_and_kill(env):
    h0, h1 = env.get_handles()
    env.add_agents(h0, method="custom", pos=[[3, 3]])
    env.add_agents(h1, method="custom", pos=[[4, 3]])
    base, v2a = env.get_view2attack(h0)
    rounds = 0
    while True:
        env.set_action(h0, np.array([base + v2a[6, 7]], np.int32))
        env.set_action(h1, np.array([6], np.int32))
        done = env.step()
        r0, r1 = env.get_reward(h0), env.get_reward(h1)
        rounds += 1
        if not env.get_alive(h1)[0]:
            assert r0[0] == pytest.approx(-0.005 - 0.1 + 5)
            assert r1[0] == pytest.approx(-0.1) and done
            break
        assert r0[0] == pytest.approx(-0.005 - 0.1 + 0.2)
        env.clear_dead()
        assert rounds < 50
    assert rounds == 6


def _scenario_clear_dead_compaction(env):
    h0, h1 = env.get_handles()
    env.add_agents(h0, method="custom", pos=[[3, 3], [6, 6], [9, 9]])
    env.add_agents(h1, method="custom", pos=[[4, 3]])
    base, v2a = env.get_view2attack(h1)
    for _ in range(10):
        env.set_action(h0, np.full(3, 6, dtype=np.int32))
        env.set_action(h1, np.array([base + v2a[6, 5]], np.int32))
        env.step()
        if not env.get_alive(h0)[0]:
            break
        env.clear_dead()
    ids_before = env.get_agent_id(h0)
    env.clear_dead()
    assert env.get_num(h0) == 2
    assert list(env.get_agent_id(h0)) == list(ids_before[1:])
    assert int(env.state.cell_slot[0, 3, 3]) == -1


def _scenario_both_attack(env):
    h0, h1 = env.get_handles()
    env.add_agents(h0, method="custom", pos=[[3, 3], [5, 3]])
    env.add_agents(h1, method="custom", pos=[[4, 3]])
    base, v2a = env.get_view2attack(h0)
    right, left = base + v2a[6, 7], base + v2a[6, 5]
    env.set_action(h0, np.array([right, left], np.int32))
    env.set_action(h1, np.array([6], np.int32))
    env.step()
    assert env.get_both_attack() == 1
    env.clear_dead()
    env.set_action(h0, np.array([left, right], np.int32))
    env.set_action(h1, np.array([6], np.int32))
    env.step()
    assert env.get_both_attack() == 0


def _scenario_mean_info(env):
    h0, _ = env.get_handles()
    env.add_agents(h0, method="custom", pos=[[3, 3], [5, 5]])
    info = env.get_mean_info(h0)
    np.testing.assert_array_equal(info[2:], 0.0)
    assert info[0] == pytest.approx(4.0) and info[1] == pytest.approx(4.0)
    with pytest.raises(ValueError):
        env.t.add_agents(h0, method="custom", pos=[[3, 3, 7]])


def _scenario_starve_death(env):
    (h0,) = env.get_handles()
    env.add_agents(h0, method="custom", pos=[[3, 3]])
    alive_steps = 0
    for _ in range(10):
        env.set_action(h0, np.zeros(1, np.int32))
        done = env.step()
        if not env.get_alive(h0)[0]:
            assert env.get_reward(h0)[0] == pytest.approx(-2.0) and done
            break
        alive_steps += 1
        env.clear_dead()
    assert alive_steps == 2


SCENARIOS = {
    "add_and_observe": (_tiny_battle, _scenario_add_and_observe),
    "move_and_collision": (_tiny_battle, _scenario_move_and_collision),
    "attack_and_kill": (_tiny_battle, _scenario_attack_and_kill),
    "clear_dead_compaction": (_tiny_battle, _scenario_clear_dead_compaction),
    "both_attack": (_tiny_battle, _scenario_both_attack),
    "mean_info": (_tiny_battle, _scenario_mean_info),
    "starve_death": (_starver, _scenario_starve_death),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_basic_scenarios_match_jax(name):
    make_config, scenario = SCENARIOS[name]
    env = dual(make_config, caps=16 if make_config is _tiny_battle else 4)
    env.reset()
    scenario(env)


def test_forest_api_demo_flow_matches_jax():
    """examples/api_demo.py's flow: forest, random interior walls (4% of
    the map), random deer and tigers, random steps."""
    env = dual("forest", map_size=30)
    deer, tiger = env.get_handles()
    env.reset()
    env.add_walls(method="random", n=30 * 30 * 0.04)
    env.add_agents(deer, method="random", n=25)
    env.add_agents(tiger, method="random", n=10)
    random_round(env, np.random.RandomState(4), 4)


def _place_armies(env, map_size):
    """examples/train_battle.py:25-42 generate_map, first round."""
    side_len = int(math.sqrt(int(map_size * map_size * 0.04))) * 2
    y0 = (map_size - side_len) // 2

    def square(x0):
        return [[x, y, 0] for x in range(x0, x0 + side_len, 2)
                for y in range(y0, y0 + side_len, 2)]

    h0, h1 = env.get_handles()
    env.add_agents(h0, method="custom", pos=square(map_size // 2 + 3))
    env.add_agents(h1, method="custom", pos=square(map_size // 2 - 3 - side_len))


def test_battle_125_slice_matches_jax(monkeypatch):
    """The slice as a whole: battle at map 125 with train_battle's 2x625
    armies (caps grow 256 -> 1024 per group, A = 2048), 3 steps of the loop
    with clear_dead.  The JAX package routes A > 1024 to its sort path off
    the TPU (engine.py:110); MAGENT_ATTACK_PATH=quad keeps it on the
    pairwise path the port takes."""
    monkeypatch.setenv("MAGENT_ATTACK_PATH", "quad")
    env = dual("battle", check_state=False, map_size=125)
    env.reset()
    _place_armies(env, 125)
    assert [env.get_num(h) for h in env.get_handles()] == [625, 625]
    assert env.t.spec.n_agents_cap == 2048
    _assert_state(env.t, env.j, "placed")
    rng = np.random.RandomState(5)
    for i in range(3):
        random_round(env, rng, 1)
        _assert_state(env.t, env.j, "step %d" % i)


def test_gridworld_runs_on_the_card_by_default():
    """Without ``device`` the GridWorld takes the GPU, and raises where
    there is none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        assert tmagent.GridWorld("battle", map_size=20).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmagent.GridWorld("battle", map_size=20)


def test_unported_modes_raise(tmp_path):
    """Sequential mode and rendering are ported: in either mode the world
    builds, steps and dumps a replay (``config.json`` and
    ``video_<k>.txt``; ``tests/test_torch_port_render.py`` holds the bytes
    against the JAX package), and no call raises the old
    ``NotImplementedError`` citing ROADMAP Queue 1 item 16."""
    for mode in ("sequential", "fast"):
        env = tmagent.GridWorld("battle", map_size=20, engine_mode=mode,
                                device="cpu")
        h0, h1 = env.get_handles()
        env.add_agents(h0, method="custom", pos=[[5, 5], [7, 5]])
        env.add_agents(h1, method="custom", pos=[[6, 6]])
        random_round(env, np.random.RandomState(0), 2)
        env.set_render_dir(str(tmp_path / mode))
        env.render()
        pos, events = env._get_render_info((0, 19), (0, 19))
        assert len(pos) == env.get_num(h0) + env.get_num(h1)
        assert events.shape[1] == 3 and events.dtype == np.int32
        assert sorted(os.listdir(tmp_path / mode)) == ["config.json",
                                                        "video_0.txt"]


def test_env_imports_no_jax():
    """Importing the port's GridWorld, DiscreteSnake and sequential engine
    pulls in neither JAX nor the JAX package."""
    code = ("import sys, magent_tpu_torch.env, magent_tpu_torch, "
            "magent_tpu_torch.discrete_snake, "
            "magent_tpu_torch.core.seq_engine; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'magent_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("modules", ["magent_tpu_torch",
                                     "magent_tpu_torch.parallel, "
                                     "magent_tpu_torch.builtin.torch_model"])
def test_package_exports_snake_and_imports_no_jax(modules):
    """``magent_tpu_torch.DiscreteSnake`` is the ported class, as the JAX
    package's alias is; importing the package alone, and the trainers and
    their nets, loads neither JAX nor any ``magent_tpu`` module."""
    import magent_tpu_torch
    from magent_tpu_torch import discrete_snake

    assert magent_tpu_torch.DiscreteSnake is discrete_snake.DiscreteSnake
    assert "DiscreteSnake" in magent_tpu_torch.__all__
    code = ("import sys, %s; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'magent_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)" % modules)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
