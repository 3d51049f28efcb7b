"""The port's reference-order GridWorld (``engine_mode="sequential"``,
``magent_tpu_torch/core/seq_engine.py`` behind ``env.py``) on the CPU:

- every C++ golden of ``tests/golden/scenarios.py`` through ``run_scenario``
  with ``tests/test_reference_parity.py``'s assertions and tolerances;
- four goldens call by call against ``magent_tpu.GridWorld(engine_mode=
  "sequential")``: every state field after every call exactly equal (hp's
  f32 bits, ``group_reward`` and ``lcg`` included), and the step's attack
  events; a world grown by ``new_group`` mid-run likewise;
- the port's rule plans (compiled, and forced onto ``GeneralRule``) against
  the port's sequential DFS on ``tests/test_rules_general.py``'s random
  reward ASTs (atol 2e-4, as there);
- the port's fast engine against its sequential engine on
  ``tests/test_engine_basic.py``'s food-crumb and negative-kill-supply
  scenarios;
- ``tests/test_determinism.py``'s sequential determinism, and the same
  trajectory as the JAX package's;
- the host round trip of the state's fields (dtypes and bits kept)."""

import os
import sys
import types

import numpy as np
import pytest
import torch

import magent_tpu as jmagent
from magent_tpu import gridworld as jgw

import magent_tpu_torch as tmagent
from magent_tpu_torch import env as tenv
from magent_tpu_torch import gridworld as tgw
from magent_tpu_torch import ops
from magent_tpu_torch import spec as tspec
from magent_tpu_torch.builtin.config import battle as tbattle
from magent_tpu_torch.core import observe as tobserve
from magent_tpu_torch.core import seq_engine as tseq

from _torch_rule_cases import (apply_port, batch_arrays, general_plans,
                               random_rule_configs)
from test_rules_general import CAPS, _random_state
from test_torch_port_gridworld import Dual, random_round

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))

from scenarios import (SCENARIOS, flatten_trace, run_scenario,  # noqa: E402
                       turn_cfg)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
DUAL_NAMES = ("battle_melee", "forest", "turn_bodies", "food_crumb")


def _port_shim():
    """A module for ``run_scenario`` whose GridWorld is the port's on the
    CPU."""
    return types.SimpleNamespace(
        gridworld=tgw,
        GridWorld=lambda cfg, **kw: tmagent.GridWorld(cfg, device="cpu",
                                                      **kw))


def assert_matches_golden(trace, golden):
    """``tests/test_reference_parity.py``'s assertions on a flattened
    trace."""
    assert int(trace["steps"]) == int(golden["steps"])
    np.testing.assert_array_equal(trace["done"], golden["done"])
    for g in range(2):
        np.testing.assert_array_equal(
            trace["num_%d" % g], golden["num_%d" % g],
            err_msg="population of group %d diverged" % g)
        for key in ("ids", "pos", "alive"):
            np.testing.assert_array_equal(
                trace["%s_%d_data" % (key, g)],
                golden["%s_%d_data" % (key, g)],
                err_msg="%s of group %d diverged" % (key, g))
        np.testing.assert_allclose(
            trace["rew_%d_data" % g], golden["rew_%d_data" % g], atol=1e-5,
            err_msg="rewards of group %d diverged" % g)
        for key in ("views_%d_data", "view0_%d", "feat0_%d"):
            if key % g in golden:
                np.testing.assert_allclose(
                    trace[key % g], golden[key % g], atol=1e-5,
                    err_msg="%s diverged" % (key % g))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sequential_port_matches_reference(name):
    golden = dict(np.load(os.path.join(GOLDEN_DIR, "golden_%s.npz" % name)))
    trace = flatten_trace(run_scenario(_port_shim(), name,
                                       engine_mode="sequential"), 2)
    assert_matches_golden(trace, golden)


class SeqDual(Dual):
    """:class:`Dual` whose ``step`` also holds the port's attack events
    (the sequential engine's exact list) against the JAX package's."""

    def __init__(self, jenv, tenv_):
        super().__init__(jenv, tenv_)
        self.events = 0

    def step(self):
        done = self.__getattr__("step")()
        assert self.t._last_attack_events == self.j._last_attack_events
        self.events += len(self.t._last_attack_events)
        return done


@pytest.mark.parametrize("name", DUAL_NAMES)
def test_sequential_port_matches_jax_call_by_call(name, monkeypatch):
    if SCENARIOS[name]["cfg"] is turn_cfg:
        # off the TPU the JAX package observes turn mode through its
        # per-direction gather (unquantized hp): the port takes it too
        monkeypatch.setattr(tobserve, "VMEM_IMAGE_BUDGET", 0)
        monkeypatch.setattr(tobserve, "_BAND_BUDGET", 0)
    worlds = []

    def make(jcfg, engine_mode):
        tcfg = SCENARIOS[name]["cfg"](tgw, SCENARIOS[name]["map_size"])
        env = SeqDual(jmagent.GridWorld(jcfg, engine_mode=engine_mode),
                      tmagent.GridWorld(tcfg, engine_mode=engine_mode,
                                        device="cpu"))
        worlds.append(env)
        return env

    shim = types.SimpleNamespace(gridworld=jgw, GridWorld=make)
    trace = run_scenario(shim, name, engine_mode="sequential")
    golden = np.load(os.path.join(GOLDEN_DIR, "golden_%s.npz" % name))
    assert trace["steps"] == int(golden["steps"])
    env = worlds[0]
    assert env.events > 0
    assert np.array_equal(env.t._dead_ct, env.j._dead_ct)


def test_sequential_new_group_and_growth_match_jax():
    """``_dead_ct`` follows ``new_group`` (one more group), ``reset`` and
    ``clear_dead``; capacity growth rebuilds the engine for the new
    spec."""
    jenv = jmagent.GridWorld("battle", map_size=24, caps=8,
                             engine_mode="sequential")
    env = SeqDual(jenv, tmagent.GridWorld("battle", map_size=24, caps=8,
                                          engine_mode="sequential",
                                          device="cpu"))
    h0, h1 = env.get_handles()
    env.reset()
    env.add_agents(h0, method="random", n=6)
    env.add_agents(h1, method="random", n=6)
    random_round(env, np.random.RandomState(3), 2)
    env.add_agents(h0, method="random", n=20)  # 8 -> 256: a new spec
    h2 = env.new_group("small")
    assert len(env.t._dead_ct) == 3
    env.add_agents(h2, method="random", n=5)
    random_round(env, np.random.RandomState(4), 4)
    env.reset()
    assert not env.t._dead_ct.any()


def _eval_seq_port(spec, S0):
    """``tests/test_rules_general.py`` ``_eval_seq`` on the port's engine."""
    A, G = spec.n_agents_cap, spec.n_groups
    S = dict(x=S0["x"].copy(), y=S0["y"].copy(),
             active=S0["active"].copy(), dead=S0["dead"].copy(),
             last_op=S0["last_op"].copy(), op_obj=S0["op_obj"].copy(),
             next_reward=np.zeros(A, np.float32),
             group_reward=np.zeros(G, np.float32),
             dir=np.zeros(A, np.int32), hp=np.ones(A, np.float32))
    tseq.SequentialEngine(spec)._calc_reward(S)
    return S["next_reward"], S["group_reward"]


def _rule_case(seed, force_general):
    """``tests/test_rules_general.py`` ``_one_case`` on the port: None where
    the rules do not compile, else True after holding the plans' rewards
    against the sequential DFS's."""
    _, tcfg, rng = random_rule_configs(seed)
    try:
        spec = tspec.compile_spec(tcfg, CAPS)
        plans = general_plans(spec) if force_general else \
            spec.compiled_rules()
    except (NotImplementedError, ValueError):
        return None
    S0 = _random_state(rng, spec)
    arrays = batch_arrays(spec, [S0], seed)
    arrays["next_reward"][:] = 0.0
    arrays["group_reward"][:] = 0.0
    nr, gr, _ = apply_port(plans, spec, arrays)
    nr_s, gr_s = _eval_seq_port(spec, S0)
    np.testing.assert_allclose(nr[0], nr_s, atol=2e-4, err_msg="seed %d" % seed)
    np.testing.assert_allclose(gr[0], gr_s, atol=2e-4, err_msg="seed %d" % seed)
    return True


@pytest.mark.parametrize("force_general", [True, False])
def test_port_rules_match_port_sequential(force_general):
    ran = sum(bool(_rule_case(seed, force_general)) for seed in range(120))
    assert ran > 60, "only %d cases were evaluable" % ran


def _hunters(mode, map_size, hunter, prey, pos0, pos1, food):
    gw = tgw
    cfg = gw.Config()
    cfg.set({"map_width": map_size, "map_height": map_size,
             "food_mode": food, "embedding_size": 4})
    g0 = cfg.add_group(cfg.register_agent_type("hunter", hunter))
    g1 = cfg.add_group(cfg.register_agent_type("prey", prey))
    assert (g0, g1) == (0, 1)
    env = tmagent.GridWorld(cfg, engine_mode=mode, device="cpu")
    h0, h1 = env.get_handles()
    env.add_agents(h0, method="custom", pos=pos0)
    env.add_agents(h1, method="custom", pos=pos1)
    return env, h0, h1


def _stay(env, group):
    sp = env.spec
    off = sp.groups[group].offset
    sdx, sdy = np.asarray(sp.s_move_dx), np.asarray(sp.s_move_dy)
    return int(np.flatnonzero((sdx[off] == 0) & (sdy[off] == 0))[0])


def test_food_crumb_fast_matches_sequential():
    """``tests/test_engine_basic.py``'s food-crumb case on the port: three
    hunters eat one corpse (8 - 3.97 - 3.97 = 0.06, a destroyed crumb);
    the fast and sequential engines give the same hp multiset and no food
    left."""
    gw = tgw
    hunter = {'width': 1, 'length': 1, 'hp': 40, 'speed': 1,
              'view_range': gw.CircleRange(4),
              'attack_range': gw.CircleRange(1), 'damage': 5,
              'step_recover': -0.5, 'eat_ability': 3.97, 'food_supply': 0,
              'kill_supply': 0, 'attack_in_group': True}
    prey = {'width': 1, 'length': 1, 'hp': 4, 'speed': 1,
            'view_range': gw.CircleRange(2),
            'attack_range': gw.CircleRange(0), 'food_supply': 8,
            'step_recover': 0}
    results = {}
    for mode in ("fast", "sequential"):
        env, h0, h1 = _hunters(mode, 16, hunter, prey,
                               [[4, 5], [5, 4], [6, 5]], [[5, 5]], True)
        v2a_base, v2a = env.get_view2attack(h0)
        cy = cx = v2a.shape[0] // 2
        at = {d: v2a_base + v2a[cy + d[1], cx + d[0]]
              for d in [(1, 0), (0, 1), (-1, 0)]}
        stay = _stay(env, 0)
        env.set_action(h0, np.array([at[(1, 0)], stay, stay], np.int32))
        env.set_action(h1, np.array([_stay(env, 1)], np.int32))
        env.step()
        env.clear_dead()
        env.set_action(h0, np.array(
            [at[(1, 0)], at[(0, 1)], at[(-1, 0)]], np.int32))
        env.step()
        results[mode] = (env.state.hp[0, :3].numpy().copy(),
                         int((env.state.cell_food >= 0).sum()))
    np.testing.assert_allclose(np.sort(results["fast"][0]),
                               np.sort(results["sequential"][0]), atol=1e-5)
    assert results["fast"][1] == results["sequential"][1] == 0


def test_negative_kill_supply_fast_matches_sequential():
    """A negative ``kill_supply`` (the victim's) lowers the killer's hp in
    both engines: 40 - 3."""
    gw = tgw
    hunter = {'width': 1, 'length': 1, 'hp': 40, 'speed': 1,
              'view_range': gw.CircleRange(3),
              'attack_range': gw.CircleRange(1), 'damage': 5,
              'step_recover': 0}
    prey = {'width': 1, 'length': 1, 'hp': 4, 'speed': 1,
            'view_range': gw.CircleRange(2),
            'attack_range': gw.CircleRange(0), 'kill_supply': -3}
    hps = {}
    for mode in ("fast", "sequential"):
        env, h0, h1 = _hunters(mode, 12, hunter, prey, [[4, 5]], [[5, 5]],
                               False)
        v2a_base, v2a = env.get_view2attack(h0)
        c = v2a.shape[0] // 2
        env.set_action(h0, np.array([v2a_base + v2a[c, c + 1]], np.int32))
        env.set_action(h1, np.array([_stay(env, 1)], np.int32))
        env.step()
        assert not env.get_alive(h1)[0]
        hps[mode] = float(env.state.hp[0, 0])
    assert hps["fast"] == hps["sequential"] == 37.0


def _determinism_run(package, seed, **kwargs):
    """``tests/test_determinism.py`` ``_run`` in sequential mode."""
    cfg_mod = __import__(package.__name__ + ".builtin.config.battle",
                         fromlist=["get_config"])
    cfg = cfg_mod.get_config(24)
    cfg.set({"seed": seed})
    env = package.GridWorld(cfg, engine_mode="sequential", **kwargs)
    h0, h1 = env.get_handles()
    env.reset()
    env.add_agents(h0, method="random", n=12)
    env.add_agents(h1, method="random", n=12)
    rng = np.random.RandomState(99)
    trace = []
    for _ in range(15):
        for h in (h0, h1):
            env.set_action(h, rng.randint(
                0, env.get_action_space(h)[0], env.get_num(h)).astype(np.int32))
        env.step()
        trace.append((env.get_pos(h0).copy(), env.get_reward(h0).copy(),
                      env.get_pos(h1).copy(), env.get_alive(h1).copy()))
        env.clear_dead()
    return trace


def test_sequential_port_deterministic_and_equal_to_jax():
    runs = [_determinism_run(tmagent, 7, device="cpu") for _ in range(2)]
    runs.append(_determinism_run(jmagent, 7))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_host_round_trip_keeps_dtypes_and_bits():
    """``env._to_device`` packs arrays of four dtypes and odd sizes into one
    copy; each comes back with its dtype, shape and bits (-0.0, NaN and
    subnormals included), and ``env._to_host`` gives independent arrays."""
    f = np.array([-0.0, np.nan, 1e-45, 3.5, -7.25], np.float32)
    arrays = [np.arange(7, dtype=np.int32) - 3, f,
              np.array([True, False, True]),
              np.arange(6, dtype=np.int32).reshape(2, 3),
              np.array([2**40 + 5], np.int64)]
    out = tenv._to_device(arrays, torch.device("cpu"))
    for a, t in zip(arrays, out):
        back = t.numpy()
        assert back.dtype == a.dtype and back.shape == (1,) + a.shape
        assert back.tobytes() == a.tobytes()
    host = tenv._to_host(out, torch.device("cpu"))
    host[0][:] = 0
    assert out[0].numpy()[0, 0] == -3


def test_sequential_step_launches_no_kernel_on_the_cpu():
    """On the CPU the wrappers take their plain versions: a sequential
    battle step counts no launch, and the engine is rebuilt only with the
    spec."""
    env = tmagent.GridWorld(tbattle.get_config(20), engine_mode="sequential",
                            device="cpu")
    h0, h1 = env.get_handles()
    env.add_agents(h0, method="custom", pos=[[5, 5], [7, 5]])
    env.add_agents(h1, method="custom", pos=[[6, 6]])
    before = ops.launch_counts()
    random_round(env, np.random.RandomState(0), 2)
    assert ops.launch_counts() == before
    engine = env._seq
    env.step()
    assert env._seq is engine and env._seq.spec is env.spec
    assert int(env.state.step_ct[0]) == 3


def test_sequential_gridworld_runs_on_the_card_by_default():
    """Without ``device`` the sequential GridWorld takes the GPU, and
    raises where there is none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        env = tmagent.GridWorld("battle", map_size=20,
                                engine_mode="sequential")
        assert env.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmagent.GridWorld("battle", map_size=20,
                              engine_mode="sequential")

