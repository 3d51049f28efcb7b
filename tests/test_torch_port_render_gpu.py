"""Replay dumps and the live battle on the card against the CPU (JAX-free):
a ``GridWorld`` (both engine modes) and the fast ``DiscreteSnake`` rendered
on ``cuda`` over two episodes, their calls replayed on the CPU through
``tests/_torch_render_replay.py``, must write the same files byte for byte;
a ``BattleServer`` on the card and one on the CPU playing the card models'
recorded actions must give equal frames.  Marked ``gpu``: each test decides
at run time whether a card exists and skips without one.  On a machine with
an H100:  python -m pytest tests/test_torch_port_render_gpu.py -q"""

import math

import numpy as np
import pytest
import torch

import magent_tpu_torch as tmag
from magent_tpu_torch import discrete_snake as tds
from magent_tpu_torch.renderer.server import BattleServer

from _torch_render_replay import (Recorder, dump_differences, frames_equal,
                                  play_actions, record_actions, replay)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _armies(map_size):
    side = int(math.sqrt(int(map_size * map_size * 0.04))) * 2
    y0 = (map_size - side) // 2
    return [[[x, y, 0] for x in range(x0, x0 + side, 2)
             for y in range(y0, y0 + side, 2)]
            for x0 in (map_size // 2 - 3 - side, map_size // 2 + 3)]


@pytest.mark.parametrize("mode", ["fast", "sequential"])
def test_gridworld_replay_gpu_matches_cpu(cuda, tmp_path, mode):
    env = Recorder(tmag.GridWorld("battle", map_size=64, engine_mode=mode,
                                  device="cuda"))
    handles = env.get_handles()
    env.set_render_dir(str(tmp_path / "cuda"))
    rng = np.random.RandomState(0)
    for steps in (12, 4):
        env.reset()
        for h, pos in zip(handles, _armies(64)):
            env.add_agents(h, method="custom", pos=pos)
        for _ in range(steps):
            for h in handles:
                env.get_observation(h)
                env.set_action(h, rng.randint(
                    0, env.get_action_space(h)[0],
                    env.get_num(h)).astype(np.int32))
            env.step()
            env.render()
            env.clear_dead()
        env._get_render_info((0, 63), (0, 63))
    replay(env.log, tmag.GridWorld("battle", map_size=64, engine_mode=mode,
                                   device="cpu"), str(tmp_path / "cpu"))
    assert dump_differences(tmp_path / "cuda", tmp_path / "cpu") == []
    text = (tmp_path / "cuda" / "video_1.txt").read_text()
    assert sum(int(ln.split()[2]) for ln in text.splitlines()
               if ln.startswith("F ")) > 0  # attack events were drawn


def test_snake_replay_gpu_matches_cpu(cuda, tmp_path):
    cfg = tds.Config()
    cfg.set({"seed": 3})
    env = Recorder(tds.DiscreteSnake(cfg, device="cuda"))
    env.set_render_dir(str(tmp_path / "cuda"))
    env.add_walls(method="random", n=50)
    env.add_food(method="random", n=500)
    env.add_agent(method="random", n=40)
    rng = np.random.RandomState(1)
    for _ in range(15):
        view, _ = env.get_observation()
        env.set_action(0, rng.randint(0, 5, len(view)).astype(np.int32))
        env.step()
        env.render()
        env.clear_dead()
    cpu_cfg = tds.Config()
    cpu_cfg.set({"seed": 3})
    replay(env.log, tds.DiscreteSnake(cpu_cfg, device="cpu"),
           str(tmp_path / "cpu"))
    assert dump_differences(tmp_path / "cuda", tmp_path / "cpu") == []


def test_battle_server_gpu_matches_cpu(cuda):
    kw = dict(map_size=48, total_step=10, add_counter=0)
    card = BattleServer(device="cuda", **kw)
    cpu = BattleServer(device="cpu", **kw)
    assert all(card.loaded) and all(cpu.loaded)
    tape = record_actions(card)
    want = [card.get_data(f, (0, 48), (0, 48)) for f in range(1, 7)]
    play_actions(cpu, tape)
    for f, w in enumerate(want, 1):
        assert frames_equal(cpu.get_data(f, (0, 48), (0, 48)), w), f
    assert sum(len(w[1]) for w in want) > 0
    assert cpu.get_banners(6, (800, 600)) == card.get_banners(6, (800, 600))
