"""Replay dumps of the port against the JAX package's, on the CPU: the same
calls go to ``magent_tpu.GridWorld`` and to
``magent_tpu_torch.GridWorld(device="cpu")`` (and to both packages' snakes),
each rendering into a directory of its own, and the directories must hold
the same files, byte for byte (``config.json``, ``video_<k>.txt``, the
snake's ``static.map``).  After every step both packages'
``attack_events`` are equal, and ``_get_render_info``, ``_get_groups_info``
and ``_get_walls_info`` are equal wherever they are called.  Every world
runs in both engine modes: battle map 16 (``tests/test_render.py``'s
layout) and map 125 with 2x625, the file numbering around ``reset()``, the
first frame's event gating and ``_get_render_info``'s activation, the
phantom-event case of ``tests/test_render.py``, pursuit's 2x2 predators,
turn mode and the absorb world (the golden layouts of
``tests/golden/scenarios.py``).  The NumPy geometry helpers are held
against JAX's on every direction."""

import math
import os
import sys

import numpy as np
import pytest
import torch

import magent_tpu as jmag
from magent_tpu import discrete_snake as jds
from magent_tpu.core import geometry as jgeo
from magent_tpu.render import generator as jgen

import magent_tpu_torch as tmag
from magent_tpu_torch import discrete_snake as tds
from magent_tpu_torch.core import geometry as tgeo
from magent_tpu_torch.render import generator as tgen

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))

from scenarios import SCENARIOS  # noqa: E402

MODES = ("fast", "sequential")


@pytest.fixture(autouse=True)
def _one_thread():
    # many small tensor ops: one intra-op thread keeps six test workers
    # from stalling each other's OpenMP barriers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """A JAX and a port GridWorld built from one config, rendering into
    ``tmp/jax`` and ``tmp/torch``; ``events`` counts the attack events of
    the steps taken."""

    def __init__(self, tmp, mode, cfg=None, name=None, **kwargs):
        self.tmp = tmp
        self.envs = []
        for mag, extra in ((jmag, {}), (tmag, {"device": "cpu"})):
            config = cfg(mag.gridworld) if cfg is not None else name
            self.envs.append(mag.GridWorld(config, engine_mode=mode,
                                           **extra, **kwargs))
        self.j, self.t = self.envs
        self.handles = self.t.get_handles()
        self.events = 0

    def call(self, name, *args, **kwargs):
        """``name`` on both envs -> (JAX's result, the port's)."""
        return tuple(getattr(e, name)(*args, **kwargs) for e in self.envs)

    def set_render_dir(self):
        for e, sub in zip(self.envs, ("jax", "torch")):
            e.set_render_dir(str(self.tmp / sub))

    def place(self, placements):
        for h, pos in zip(self.handles, placements):
            self.call("add_agents", h, method="custom", pos=pos)

    def step(self, rng, render=True, clear=True, acts=None):
        for h in self.handles:
            n = self.j.get_num(h)
            assert self.t.get_num(h) == n
            a = acts(h, n) if acts is not None else rng.randint(
                0, self.j.get_action_space(h)[0], n).astype(np.int32)
            self.call("set_action", h, a)
        done = self.call("step")
        assert done[0] == done[1]
        want = jgen.attack_events(self.j)
        assert tgen.attack_events(self.t) == want
        if self.t._engine_mode == "sequential":
            assert self.t._last_attack_events == want
        self.events += len(want)
        if render:
            self.call("render")
        if clear:
            self.call("clear_dead")
        return done[0]

    def assert_info(self, x_range, y_range):
        (jpos, jev), (tpos, tev) = self.call("_get_render_info", x_range,
                                             y_range)
        assert tpos == jpos and list(tpos) == list(jpos)
        assert tev.dtype == jev.dtype == np.int32
        np.testing.assert_array_equal(tev, jev)
        for name in ("_get_groups_info", "_get_walls_info"):
            want, got = self.call(name)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)
        return tpos, tev


def assert_dirs_equal(tmp, files):
    """``tmp/jax`` and ``tmp/torch`` hold exactly ``files``, byte for
    byte equal."""
    jdir, tdir = tmp / "jax", tmp / "torch"
    assert sorted(os.listdir(jdir)) == sorted(files)
    assert sorted(os.listdir(tdir)) == sorted(files)
    for f in files:
        want = (jdir / f).read_bytes()
        assert (tdir / f).read_bytes() == want, f
        assert want


def _squares(map_size, frac):
    """``examples/train_battle.py``'s two armies (stride 2, 3 cells either
    side of the middle)."""
    side = int(math.sqrt(int(map_size * map_size * frac))) * 2
    y0 = (map_size - side) // 2

    def square(x0):
        return [[x, y, 0] for x in range(x0, x0 + side, 2)
                for y in range(y0, y0 + side, 2)]

    return [square(map_size // 2 - 3 - side), square(map_size // 2 + 3)]


def _golden(name):
    sc = SCENARIOS[name]
    return (lambda gw: sc["cfg"](gw, sc["map_size"])), sc


@pytest.mark.parametrize("mode", MODES)
def test_render_battle16_matches_jax(tmp_path, mode):
    """``tests/test_render.py``'s dump: two agents a side on map 16."""
    pair = Pair(tmp_path, mode, name="battle", map_size=16)
    pair.set_render_dir()
    pair.call("reset")
    pair.place([[[3, 3], [5, 5]], [[10, 10], [12, 12]]])
    rng = np.random.RandomState(0)
    for _ in range(3):
        pair.step(rng)
    pair.assert_info((0, 16), (0, 16))
    assert_dirs_equal(pair.tmp, ["config.json", "video_1.txt"])


@pytest.mark.parametrize("mode", MODES)
def test_render_battle125_matches_jax(tmp_path, mode):
    """train_battle's map 125 with 2x625 agents, three rendered steps."""
    pair = Pair(tmp_path, mode, name="battle", map_size=125)
    pair.set_render_dir()
    pair.call("reset")
    pair.place(_squares(125, 0.04))
    assert [pair.t.get_num(h) for h in pair.handles] == [625, 625]
    rng = np.random.RandomState(1)
    for _ in range(3):
        pair.step(rng)
    pos, _ = pair.assert_info((0, 124), (0, 124))
    assert len(pos) == 1250
    assert_dirs_equal(pair.tmp, ["config.json", "video_1.txt"])


@pytest.mark.parametrize("mode", MODES)
def test_render_file_numbering_matches_jax(tmp_path, mode):
    """A render before the first ``reset()`` writes ``video_0``; every
    reset moves to the next file; resets before the first render are
    counted (the reference bumps the number on every reset,
    GridWorld.cc:97)."""
    pair = Pair(tmp_path / "a", mode, name="battle", map_size=16)
    pair.set_render_dir()
    rng = np.random.RandomState(2)
    for episode in range(3):
        if episode:
            pair.call("reset")
        pair.place([[[3, 3], [5, 5]], [[6, 3], [8, 5]]])
        pair.step(rng)
        pair.step(rng)
    assert_dirs_equal(pair.tmp, ["config.json", "video_0.txt", "video_1.txt",
                       "video_2.txt"])

    pair = Pair(tmp_path / "b", mode, name="battle", map_size=16)
    pair.call("reset")
    pair.set_render_dir()
    pair.call("reset")
    pair.place([[[3, 3]], [[4, 3]]])
    pair.step(rng)
    assert_dirs_equal(pair.tmp, ["config.json", "video_2.txt"])


@pytest.mark.parametrize("mode", MODES)
def test_render_event_gating_matches_jax(tmp_path, mode):
    """The first frame after activation carries no events; a
    ``_get_render_info`` query activates event capture: its first answer
    has none, later ones last step's.  battle_melee's layout, where
    attacks land from step one."""
    cfg, sc = _golden("battle_melee")
    rng = np.random.RandomState(sc["action_seed"])
    pair = Pair(tmp_path / "render", mode, cfg=cfg)
    pair.set_render_dir()
    pair.call("reset")
    pair.place(sc["placements"])
    pair.step(rng)  # first frame: no events
    assert pair.events > 0
    first = (tmp_path / "render" / "torch" / "video_1.txt").read_text()
    assert first.splitlines()[0].startswith("W ")
    frame = [ln for ln in first.splitlines() if ln.startswith("F ")]
    assert frame[0].split()[2] == "0"
    for _ in range(3):
        pair.step(rng)
    assert_dirs_equal(pair.tmp, ["config.json", "video_1.txt"])
    frames = [ln for ln in (tmp_path / "render" / "torch" /
                            "video_1.txt").read_text().splitlines()
              if ln.startswith("F ")]
    assert sum(int(f.split()[2]) for f in frames[1:]) > 0

    pair = Pair(tmp_path / "query", mode, cfg=cfg)
    pair.call("reset")
    pair.place(sc["placements"])
    pair.step(rng, render=False, clear=False)
    _, events = pair.assert_info((0, 23), (0, 23))
    assert len(events) == 0  # the first query activates capture
    pair.call("clear_dead")
    pair.step(rng, render=False, clear=False)
    _, events = pair.assert_info((0, 23), (0, 23))
    assert len(events) > 0
    pair.call("clear_dead")
    pair.set_render_dir()
    pair.step(rng)  # rendering already active: this frame has events
    assert_dirs_equal(pair.tmp, ["config.json", "video_1.txt"])


@pytest.mark.parametrize("mode", MODES)
def test_render_no_phantom_events_matches_jax(tmp_path, mode):
    """``tests/test_render.py``'s phantom case: an agent killed in an
    earlier step emits no event from its sticky ``last_op`` when the world
    is stepped on without ``clear_dead``."""
    pair = Pair(tmp_path, mode, name="battle", map_size=16)
    pair.set_render_dir()
    pair.call("reset")
    pair.place([[[3, 3]], [[4, 3]]])
    b0, v2a0 = pair.t.get_view2attack(pair.handles[0])
    c = v2a0.shape[0] // 2
    right, stay = int(b0 + v2a0[c, c + 1]), 6

    def acts(h, n):
        return np.full(n, right if h.value == 0 else stay, np.int32)

    rng = np.random.RandomState(0)
    for _ in range(30):
        pair.step(rng, clear=False, acts=acts)
        if not pair.t.get_alive(pair.handles[1]).all():
            break
        pair.call("clear_dead")
    assert not pair.t.get_alive(pair.handles[1]).all()
    for _ in range(2):
        before = pair.events
        pair.step(rng, clear=False, acts=acts)
        assert pair.events - before == 1
    pair.assert_info((0, 15), (0, 15))
    assert_dirs_equal(pair.tmp, ["config.json", "video_1.txt"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["pursuit", "turn_bodies", "absorb"])
def test_render_golden_worlds_match_jax(tmp_path, mode, name):
    """pursuit's 2x2 predators (multi-cell attackers and targets),
    turn_bodies' 1x2 bodies in all four facings (angles), and the absorb
    world (only absorbed goal markers are drawn): the golden layouts,
    rendered for 12 steps."""
    cfg, sc = _golden(name)
    rng = np.random.RandomState(sc["action_seed"])
    pair = Pair(tmp_path, mode, cfg=cfg)
    pair.set_render_dir()
    pair.call("reset")
    pair.place(sc["placements"])
    absorbed, goals = [], []  # per frame: absorbed goals, all goals
    for _ in range(12):
        done = pair.step(rng, clear=False)
        absorbed.append(int(pair.t._host("absorbed", pair.handles[0]).sum()))
        goals.append(pair.t.get_num(pair.handles[0]))
        pair.call("clear_dead")
        if done:
            break
    m = sc["map_size"]
    pos, _ = pair.assert_info((0, m - 1), (0, m - 1))
    assert_dirs_equal(pair.tmp, ["config.json", "video_1.txt"])
    text = (tmp_path / "torch" / "video_1.txt").read_text().splitlines()
    frames = []  # each frame's agent lines
    for k, ln in enumerate(text):
        if ln.startswith("F "):
            frames.append([a.split() for a in
                           text[k + 1:k + 1 + int(ln.split()[1])]])
    if name == "absorb":
        assert any(0 < n < g for n, g in zip(absorbed, goals))
        assert [sum(a[5] == "0" for a in f) for f in frames] == absorbed
        assert sum(p[2] == 0 for p in pos.values()) == absorbed[-1]
    else:
        assert pair.events > 0
    if name == "turn_bodies":
        assert {a[2] for f in frames for a in f} == {"0", "90", "180",
                                                      "270"}


def _snake_cfg(module):
    """``tests/test_snake.py`` ``make_env``'s config."""
    cfg = module.Config()
    cfg.set(dict(map_width=24, map_height=24, view_width=7, view_height=7,
                 max_dead_penalty=-10, corpse_value=1, total_resource=30,
                 embedding_size=8, seed=3))
    return cfg


@pytest.mark.parametrize("mode", MODES)
def test_snake_render_matches_jax(tmp_path, mode):
    """Both snakes' dumps (``config.json``, ``static.map``, a video file
    per episode) over two episodes with the same actions."""
    kw = {"caps": 16, "max_length": 16} if mode == "fast" else {}
    envs = [jds.DiscreteSnake(_snake_cfg(jds), engine_mode=mode, **kw),
            tds.DiscreteSnake(_snake_cfg(tds), engine_mode=mode,
                              **(dict(kw, device="cpu") if kw else {}))]
    for e, sub in zip(envs, ("jax", "torch")):
        e.set_render_dir(str(tmp_path / sub))
    rng = np.random.RandomState(5)
    for episode in range(2):
        for e in envs:
            if episode:
                e.reset()
            e.add_walls(method="random", n=6)
            e.add_food(method="random", n=15)
            e.add_agent(method="random", n=6)
        for _ in range(10):
            n = envs[0].get_num()
            assert envs[1].get_num() == n
            acts = rng.randint(0, 5, n).astype(np.int32)
            for e in envs:
                e.set_action(0, acts)
                e.step()
                e.render()
                e.clear_dead()
    assert_dirs_equal(tmp_path, ["config.json", "static.map", "video_0.txt",
                                 "video_1.txt"])


def test_geometry_np_matches_jax():
    """``size_for_dir_np``, ``save_to_real_np`` and ``rela_to_abs_np`` on
    every direction, on scalars and arrays."""
    rng = np.random.RandomState(0)
    x, y, rx, ry = (rng.randint(-50, 50, 64).astype(np.int32)
                    for _ in range(4))
    for d in range(4):
        for w, l in ((1, 1), (2, 2), (1, 2), (3, 1)):
            assert tgeo.size_for_dir_np(d, w, l) == \
                jgeo.size_for_dir_np(d, w, l)
            for args in ((x, y, d, w, l), (int(x[0]), int(y[0]), d, w, l)):
                for got, want in zip(tgeo.save_to_real_np(*args),
                                     jgeo.save_to_real_np(*args)):
                    np.testing.assert_array_equal(got, want)
        dd = np.full(64, d, np.int32)
        for got, want in zip(tgeo.rela_to_abs_np(x, y, dd, rx, ry),
                             jgeo.rela_to_abs_np(x, y, dd, rx, ry)):
            np.testing.assert_array_equal(got, want)
    dmix = rng.randint(0, 4, 64).astype(np.int32)
    for got, want in zip(tgeo.save_to_real_np(x, y, dmix, 2, 3),
                         jgeo.save_to_real_np(x, y, dmix, 2, 3)):
        np.testing.assert_array_equal(got, want)


def test_to_host_is_one_exact_copy():
    """``render.generator.to_host``: shapes, dtypes and values (f32 bits,
    a NaN and -0.0 included) back from one buffer; other dtypes raise."""
    hp = torch.tensor([1.5, -0.0, float("nan"), 3e-38], dtype=torch.float32)
    ids = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    alive = torch.tensor([True, False, True])
    got = tgen.to_host([hp, ids, alive])
    assert [a.dtype for a in got] == [np.float32, np.int32, np.bool_]
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  hp.numpy().view(np.int32))
    np.testing.assert_array_equal(got[1], ids.numpy())
    np.testing.assert_array_equal(got[2], alive.numpy())
    with pytest.raises(TypeError):
        tgen.to_host([torch.zeros(2, dtype=torch.int64)])
