"""The port's DiscreteSnake on the CPU:

- ``core/glibc_random.py``'s streams equal the JAX package's copy for 10^4
  draws at several seeds;
- the port's ``SequentialSnake`` (``engine_mode="sequential"``) reproduces
  the C++ golden ``snake_basic`` (``tests/test_snake_parity.py``'s
  assertions) and equals the JAX package's step for step;
- the fast ``DiscreteSnake(device="cpu")`` equals the JAX package's step
  for step over 40 steps at ``tests/test_snake.py``'s sizes, with
  ``max_length`` 16 and 4 (the forced tail pop): every state field (the
  threefry ``key`` words included), views, features and rewards, exactly
  (the JAX package observes through ``window_gather_xla`` on the CPU);
- the padded image geometry at the snake's shapes equals the JAX
  package's;
- the invariant cases of ``tests/test_snake.py`` on the port (the render
  dump's bytes are held against the JAX package by
  ``tests/test_torch_port_render.py``)."""

import os
import sys
import types

import numpy as np
import pytest
import torch

from magent_tpu import discrete_snake as jds
from magent_tpu.core import glibc_random as jglibc
from magent_tpu.ops import window_gather as jwg

import magent_tpu_torch as tmagent
from magent_tpu_torch import discrete_snake as tds
from magent_tpu_torch.core import glibc_random as tglibc
from magent_tpu_torch.discrete_snake import (ACT_LEFT, ACT_NOOP, ACT_RIGHT,
                                             SNAKE_FIELDS)
from magent_tpu_torch.ops import window_gather as twg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))

from scenarios import flatten_snake_trace, run_snake_scenario  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _same(got, want):
    """Exactly equal: f32 by bits, the rest by value (uint32 key words
    against the port's int64 words)."""
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.shape == want.shape
    if want.dtype == np.float32:
        assert got.dtype == np.float32
        return np.array_equal(got.view(np.int32), want.view(np.int32))
    return np.array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, 2**32 - 1])
def test_glibc_random_matches_jax(seed):
    a, b = tglibc.GlibcRandom(seed), jglibc.GlibcRandom(seed)
    assert [a.random() for _ in range(10**4)] == \
        [b.random() for _ in range(10**4)]


class SnakeDual:
    """Forwards every call to a JAX and a port snake and asserts equal
    results (and, with ``state``, equal states after every call); returns
    the port's result."""

    def __init__(self, jenv, tenv, state):
        self.j, self.t, self.state_check = jenv, tenv, state
        self.calls = 0

    def __getattr__(self, name):
        jf, tf = getattr(self.j, name), getattr(self.t, name)

        def call(*args, **kwargs):
            want = jf(*args, **kwargs)
            got = tf(*args, **kwargs)
            for g, w in zip(*((x if isinstance(x, tuple) else (x,))
                              for x in (got, want))):
                if isinstance(w, np.ndarray):
                    assert _same(g, w), name
                else:
                    assert g == w, (name, g, w)
            if self.state_check:
                for f in SNAKE_FIELDS:
                    assert _same(getattr(self.t.state, f).numpy(),
                                 np.asarray(getattr(self.j.state, f))), (
                        name, f)
            self.calls += 1
            return got

        return call


def _dual_module(make):
    """A package-like module for ``run_snake_scenario``, whose
    ``discrete_snake.DiscreteSnake`` is ``make``."""
    pkg = types.ModuleType("snake_dual")
    pkg.discrete_snake = types.SimpleNamespace(Config=tds.Config,
                                               DiscreteSnake=make)
    return pkg


def test_sequential_snake_matches_reference_and_jax(monkeypatch):
    name = "snake_basic"
    golden = dict(np.load(os.path.join(GOLDEN_DIR, "golden_%s.npz" % name)))
    envs = []

    def make(cfg, engine_mode):
        jcfg = jds.Config()
        jcfg.set(cfg.config_dict)
        env = SnakeDual(jds.DiscreteSnake(jcfg, engine_mode=engine_mode),
                        tds.DiscreteSnake(cfg, engine_mode=engine_mode),
                        state=False)
        envs.append(env)
        return env

    pkg = _dual_module(make)
    monkeypatch.setitem(sys.modules, "snake_dual", pkg)
    monkeypatch.setitem(sys.modules, "snake_dual.discrete_snake",
                        pkg.discrete_snake)
    trace = flatten_snake_trace(run_snake_scenario(pkg, name,
                                                   engine_mode="sequential"))
    assert type(envs[0].t).__module__ == "magent_tpu_torch.core.seq_snake"
    assert envs[0].calls > 400
    assert int(trace["steps"]) == int(golden["steps"])
    np.testing.assert_array_equal(trace["num"], golden["num"])
    np.testing.assert_array_equal(trace["food_num"], golden["food_num"])
    for key in ("ids_data", "head_data", "length_data", "alive_data"):
        np.testing.assert_array_equal(
            np.asarray(trace[key], np.int64),
            np.asarray(golden[key], np.int64), err_msg=key)
    np.testing.assert_allclose(trace["rew_data"], golden["rew_data"],
                               atol=1e-5)
    np.testing.assert_allclose(trace["view0"], golden["view0"], atol=1e-5)
    np.testing.assert_allclose(trace["feat0"], golden["feat0"], atol=1e-5)


def _config(module, **over):
    """``tests/test_snake.py`` ``make_env``'s config."""
    cfg = module.Config()
    conf = dict(map_width=24, map_height=24, view_width=7, view_height=7,
                max_dead_penalty=-10, corpse_value=1, total_resource=30,
                embedding_size=8, seed=3)
    conf.update(over)
    cfg.set(conf)
    return cfg


def make_env(max_length=16, **over):
    return tds.DiscreteSnake(_config(tds, **over), caps=16,
                             max_length=max_length, device="cpu")


@pytest.mark.parametrize("max_length", [16, 4])
def test_fast_snake_matches_jax_step_for_step(max_length):
    env = SnakeDual(
        jds.DiscreteSnake(_config(jds), caps=16, max_length=max_length),
        make_env(max_length), state=True)
    env.reset()
    env.add_walls(method="random", n=10)
    env.add_food(method="random", n=20)
    env.add_agent(method="random", n=12)
    rng = np.random.RandomState(0)
    seen = dict(dead=0, ate=0, capped=0, spawned=0)
    for step in range(40):
        view, feat = env.get_observation()
        n = env.get_num()
        assert view.shape == (n, 7, 7, 5) and feat.shape == (n, 14)
        env.get_agent_id()
        env.get_head()
        env.get_length()
        food0 = env.get_food_num()
        env.set_action(0, rng.randint(0, 5, n).astype(np.int32))
        env.step()
        rew = env.get_reward()
        alive = env.get_alive()
        st = env.t.state
        seen["dead"] += int((~alive).sum())
        seen["ate"] += int(((rew > 0) & alive).sum())
        seen["capped"] += int((st.length[st.alive] >= max_length).sum())
        seen["spawned"] += int(env.get_food_num() > food0)
        env.clear_dead()
        if env.get_num() == 0:
            env.add_agent(method="random", n=12)
    # deaths, eats and spawns at both lengths; the full ring at 4
    assert all(v for k, v in seen.items()
               if k != "capped" or max_length == 4), seen


@pytest.mark.parametrize("view", [7, 11, 21])
def test_padded_geometry_matches_jax_at_snake_shapes(view):
    for H, W in ((24, 24), (100, 100), (14, 16)):
        assert twg.padded_geometry(H, W, tds.CHANNEL_NUM, view, view) == \
            jwg.padded_geometry(H, W, jds.CHANNEL_NUM, view, view)


def test_snake_runs_on_the_card_by_default():
    """Without ``device`` the fast snake takes the GPU, and raises where
    there is none; the sequential snake is host-only and takes none."""
    if torch.cuda.is_available():
        assert tds.DiscreteSnake(_config(tds)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tds.DiscreteSnake(_config(tds))
    seq = tds.DiscreteSnake(_config(tds), engine_mode="sequential")
    assert isinstance(seq, tmagent.discrete_snake.SequentialSnake)


@pytest.mark.parametrize("mode", ["fast", "sequential"])
def test_snake_render_is_not_ported(mode, tmp_path):
    """Rendering is ported: ``render`` does nothing until
    ``set_render_dir`` attaches a dumper, which writes ``config.json`` and
    ``static.map`` at once and a frame per ``render``."""
    kwargs = {"device": "cpu"} if mode == "fast" else {}
    env = tds.DiscreteSnake(_config(tds), engine_mode=mode, **kwargs)
    env.render()  # no generator: nothing to write
    env.render_next_file()
    env.set_render_dir(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["config.json", "static.map"]
    env.render()
    assert (tmp_path / "video_0.txt").read_text().startswith("F ")


# ---- tests/test_snake.py's invariant cases on the port ----

def test_snake_basic_episode():
    env = make_env()
    env.reset()
    env.add_food(method="random", n=20)
    env.add_agent(method="random", n=4)
    assert env.get_num() == 4
    assert env.get_view_space() == (7, 7, 5)
    assert env.get_feature_space() == (8 + 5 + 1,)
    assert (env.get_length() == 3).all()

    rng = np.random.RandomState(0)
    for _ in range(20):
        view, feat = env.get_observation()
        n = env.get_num()
        assert view.shape == (n, 7, 7, 5)
        acts = rng.randint(0, env.get_action_space()[0], n).astype(np.int32)
        env.set_action(0, acts)
        env.step()
        env.clear_dead()
        if env.get_num() == 0:
            break
    # food rebalancing keeps resources around the target
    assert env.get_food_num() > 0


def test_snake_eats_and_grows():
    env = make_env(total_resource=0)  # no auto-spawn noise
    env.reset()
    env.add_agent(method="random", n=1)
    (hx, hy), = env.get_head()
    food = env.state.cell_food.clone()
    if hx + 1 < 23:
        food[hy, hx + 1] = 1.0
    env.state = env.state.replace(cell_food=food)
    env.set_action(0, np.asarray([ACT_RIGHT], np.int32))
    env.step()
    if env.get_alive()[0]:
        assert env.get_reward()[0] == 1.0
        env.set_action(0, np.asarray([ACT_RIGHT], np.int32))
        env.step()
        if env.get_alive()[0]:
            assert env.get_length()[0] == 4  # grew by the eaten value


def test_snake_wall_death():
    env = make_env(total_resource=0)
    env.reset()
    env.add_agent(method="random", n=1)
    for _ in range(30):
        env.set_action(0, np.asarray([ACT_LEFT], np.int32))
        env.step()
        if not env.get_alive()[0]:
            break
    assert not env.get_alive()[0]
    assert env.get_reward()[0] == 10.0  # -max_dead_penalty
    env.clear_dead()
    assert env.get_num() == 0


def _footprint(st):
    """The live snakes' body cells counted from the rings."""
    ct = st.cell_ct.numpy()
    expect = np.zeros_like(ct)
    bx, by = st.body_x.numpy(), st.body_y.numpy()
    head, length = st.head.numpy(), st.length.numpy()
    alive = (st.alive & st.active).numpy()
    L = bx.shape[1]
    for s in np.nonzero(alive)[0]:
        for i in range(int(length[s])):
            ring = (int(head[s]) - i) % L
            expect[by[s, ring], bx[s, ring]] += 1
    return ct, expect


@pytest.mark.parametrize("max_length,over,n_food,n_agents,act_seed", [
    (16, dict(map_width=14, map_height=14, total_resource=60, seed=11), 30,
     10, 1),
    (4, dict(map_width=16, map_height=16, total_resource=100,
             corpse_value=3, seed=5), 60, 4, 2)],
    ids=["collisions", "full_ring_forced_pop"])
def test_snake_grid_invariants(max_length, over, n_food, n_agents, act_seed):
    """``cell_ct`` stays non-negative and equals the live snakes' body
    footprint after deaths and (with ``max_length`` 4) forced tail pops."""
    env = make_env(max_length, **over)
    env.reset()
    env.add_food(method="random", n=n_food)
    env.add_agent(method="random", n=n_agents)
    rng = np.random.RandomState(act_seed)
    hit_cap = False
    for step in range(60 if max_length == 16 else 50):
        n = env.get_num()
        if n == 0:
            break
        env.set_action(0, rng.randint(0, 4, n).astype(np.int32))
        env.step()
        st = env.state
        hit_cap |= bool((st.length[st.alive & st.active] >= 4).any())
        ct, expect = _footprint(st)
        assert (ct >= 0).all(), "negative cell_ct at step %d" % step
        np.testing.assert_array_equal(ct, expect, err_msg="step %d" % step)
        env.clear_dead()
    if max_length == 4:
        assert hit_cap, "no snake ever reached the ring capacity"


def test_noop_and_reverse_keep_direction():
    """NOOP and the reverse of the current direction leave ``dir`` as it
    is; the head moves one cell along it."""
    env = make_env(total_resource=0)
    env.reset()
    env.add_agent(method="random", n=1)
    d0 = int(env.state.dir[0])
    reverse = int(tds._INVERSE[d0])
    for act in (ACT_NOOP, reverse):
        (hx, hy), = env.get_head()
        env.set_action(0, np.asarray([act], np.int32))
        env.step()
        if not env.get_alive()[0]:
            break
        assert int(env.state.dir[0]) == d0
        assert tuple(env.get_head()[0]) == (hx + tds._DELTA[d0][0],
                                            hy + tds._DELTA[d0][1])
