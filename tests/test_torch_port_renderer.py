"""The port's live-game servers and PyGame client on the CPU: ``SampleServer``,
``RandomServer`` and a ``BattleServer`` under ``PyGameRenderer`` headless
(SDL's dummy video output, as ``tests/test_renderer.py``); the port's
``BattleServer(map_size=32, device="cpu")`` with the bundled trusty
checkpoints against the JAX package's server frame by frame (``get_info``,
``get_data``'s agents and attack events, ``get_banners``, ``get_status``;
actions equal where the port's top two Q values lie more than 1e-5 apart,
a tie's JAX action one of the port's tied ones and played by both, as
``tests/_torch_model_play.py``'s rule); ``ArrangeServer(map_size=48,
device="cpu")`` against the JAX server (``RandomActor`` from one NumPy
seed); the example entry points; that importing the render and renderer
packages loads no ``jax``, no ``magent_tpu`` and no ``pygame``; and that the
servers default to the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

from magent_tpu.renderer import server as jserver  # noqa: E402

from magent_tpu_torch.renderer import PyGameRenderer  # noqa: E402
from magent_tpu_torch.renderer import server as tserver  # noqa: E402

from _torch_model_play import MARGIN, port_scores, top_two_gap  # noqa: E402
from _torch_render_replay import record_actions  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pygame():
    return pytest.importorskip("pygame")


def test_renderer_runs_sample_and_random_servers(pygame):
    PyGameRenderer().start(tserver.SampleServer(), max_frames=5, fps=100)
    PyGameRenderer().start(tserver.RandomServer(agent_number=50, map_size=40),
                           max_frames=5, fps=100)


def test_renderer_runs_battle_server(pygame):
    server = tserver.BattleServer(map_size=32, total_step=6, add_counter=0,
                                  device="cpu")
    PyGameRenderer().start(server, max_frames=4, fps=100)
    assert server.env.state.step_ct[0] > 0


def _replay_port(server, jax_acts):
    """Wrap the port server's models: each call's actions equal the JAX
    model's where the port's top two Q values clear ``MARGIN``; on a tie
    the JAX action must be one of the tied ones; the JAX actions are
    played.  -> the number of ties."""
    calls, ties = [0], [0]
    for t in server.teams:
        infer = t.model.infer_action

        def wrapped(obs, ids, policy="e_greedy", eps=0, _m=t.model,
                    _infer=infer, **kwargs):
            sc, explore = port_scores("dqn", _m, obs[0], obs[1], ids, eps)
            got = _infer(obs, ids, policy, eps=eps, **kwargs)
            want = jax_acts[calls[0]]
            calls[0] += 1
            tie = ~explore & (top_two_gap(sc) <= MARGIN)
            np.testing.assert_array_equal(got[~tie], want[~tie])
            picked = sc[np.arange(len(want)), want]
            assert (picked >= sc.max(1) - MARGIN)[tie].all()
            ties[0] += int(tie.sum())
            return want

        t.model.infer_action = wrapped
    return ties


def test_battle_server_matches_jax():
    """Map 32 with the bundled checkpoints (a save dir that does not
    exist), 6 frames: info, agents, events, banners and status equal."""
    kw = dict(map_size=32, total_step=8, add_counter=0,
              path="/nonexistent-save-model")
    jsrv = jserver.BattleServer(**kw)
    tsrv = tserver.BattleServer(device="cpu", **kw)
    assert all(jsrv.loaded) and all(tsrv.loaded)
    (jsize, jgroups, jstatic), (tsize, tgroups, tstatic) = (
        jsrv.get_info(), tsrv.get_info())
    assert tsize == jsize
    np.testing.assert_array_equal(tgroups, jgroups)
    np.testing.assert_array_equal(tstatic["wall"], jstatic["wall"])
    jax_acts = record_actions(jsrv)
    want = [jsrv.get_data(f, (0, 32), (0, 32)) for f in range(1, 7)]
    ties = _replay_port(tsrv, jax_acts)
    events = 0
    for f, (jpos, jev) in enumerate(want, 1):
        tpos, tev = tsrv.get_data(f, (0, 32), (0, 32))
        assert tpos == jpos and list(tpos) == list(jpos), f
        np.testing.assert_array_equal(tev, jev)
        events += len(tev)
        assert tsrv.get_banners(f, (800, 600)) == \
            jsrv.get_banners(f, (800, 600))
        assert tsrv.get_status(f) == jsrv.get_status(f)
    assert events > 0 and ties[0] <= 2
    assert tsrv.get_endscreen(8) == jsrv.get_endscreen(8)


def test_arrange_server_matches_jax():
    """Map 48, "HI", ``RandomActor`` (no checkpoint) from one NumPy seed:
    the glyph layout, 5 frames of agents and banners, absorbed markers
    only."""
    runs = []
    for module, kw in ((jserver, {}), (tserver, {"device": "cpu"})):
        np.random.seed(3)
        srv = module.ArrangeServer(messages=["HI"], map_size=48,
                                   total_step=8, path="/nonexistent", **kw)
        run = [srv.get_info()]
        for f in range(5):
            run.append(srv.get_data(f, (0, 48), (0, 48)))
            run.append(srv.get_banners(f, (800, 600)))
        run.append(srv._goal_stay)
        runs.append((srv, run))
    (jsrv, want), (tsrv, got) = runs
    assert got[0][0] == want[0][0]
    np.testing.assert_array_equal(got[0][1], want[0][1])
    np.testing.assert_array_equal(got[0][2]["wall"], want[0][2]["wall"])
    for g, w in zip(got[1:], want[1:]):
        if isinstance(w, tuple) and len(w) == 2 and isinstance(w[0], dict):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[1], w[1])
        else:
            assert g == w
    goal = tsrv.goal_handle
    absorbed = set(tsrv.env.get_agent_id(goal)[
        tsrv.env._host("absorbed", goal)].tolist())
    drawn = {i for i, p in got[-3][0].items() if p[2] == goal.value}
    assert drawn == absorbed and 0 < len(absorbed) < tsrv.env.get_num(goal)


def test_examples_build_their_servers(monkeypatch):
    """``show_battle_game`` and ``show_arrange`` hand a server on the
    requested device to ``PyGameRenderer.start``."""
    from magent_tpu_torch.examples import show_arrange, show_battle_game

    started = []
    monkeypatch.setattr(PyGameRenderer, "start",
                        lambda self, server, **kw: started.append(server))
    show_battle_game.main(["--device", "cpu"])
    show_arrange.main(["HI", "--device", "cpu"])
    battle, arrange = started
    assert isinstance(battle, tserver.BattleServer) and all(battle.loaded)
    assert battle.env.device.type == "cpu" and battle.map_size == 125
    assert isinstance(arrange, tserver.ArrangeServer)
    assert arrange.env.device.type == "cpu" and arrange.map_size == 100


def test_render_packages_import_no_jax_and_no_pygame():
    code = ("import sys, magent_tpu_torch.render, magent_tpu_torch.renderer, "
            "magent_tpu_torch.renderer.server, "
            "magent_tpu_torch.examples.show_battle_game, "
            "magent_tpu_torch.examples.show_arrange; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'magent_tpu', 'pygame')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_servers_default_to_the_card():
    """``device=None`` is the card: without one the servers raise rather
    than fall back to the CPU."""
    for cls, kw in ((tserver.BattleServer, {"map_size": 32}),
                    (tserver.ArrangeServer, {"map_size": 48})):
        if torch.cuda.is_available():
            assert cls(**kw).env.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(**kw)
