"""Playable battle for the PyGame client: two DQN-driven armies on a live
env, with mouse-drop reinforcements for the player's side.

Port of ``magent_tpu/renderer/server/battle_server.py``: capability parity
with the reference's interactive battle game (reference:
python/magent/renderer/server/battle_server.py) through the
:class:`BaseServer` contract; the internals here are organized around a
``_Team`` tuple per side and shared formation/drop helpers instead of the
reference's inline loops.  The world and both nets live on ``device``
(``None``: the GPU, raising without one); the nets load the JAX package's
checkpoints (``data/models/trusty-battle-game-{l,r}``) bit for bit.
"""

import math
from collections import namedtuple

import numpy as np

from ... import gridworld, utility
from ...builtin.torch_model import DeepQNetwork, latest_epoch
from ...env import GridWorld

from .base_server import BaseServer

_Team = namedtuple("_Team", "handle model name color")

RED = (200, 0, 0)
BLUE = (0, 0, 200)
BLACK = (0, 0, 0)


def load_config(map_size):
    """Battle-game config: minimap-mode small soldiers with attack shaping
    (the game variant of builtin/config/battle.py; parameter table is the
    contract with the bundled checkpoints)."""
    gw = gridworld
    cfg = gw.Config()
    cfg.set({"map_width": map_size, "map_height": map_size,
             "minimap_mode": True, "embedding_size": 10})
    small = cfg.register_agent_type(
        "small",
        {'width': 1, 'length': 1, 'hp': 10, 'speed': 2,
         'view_range': gw.CircleRange(6), 'attack_range': gw.CircleRange(1.5),
         'damage': 2, 'step_recover': 0.1,
         'step_reward': -0.005, 'kill_reward': 5, 'dead_penalty': -0.1,
         'attack_penalty': -0.1})
    groups = [cfg.add_group(small), cfg.add_group(small)]
    syms = [gw.AgentSymbol(g, index='any') for g in groups]
    for me, other in ((0, 1), (1, 0)):
        cfg.add_reward_rule(gw.Event(syms[me], 'attack', syms[other]),
                            receiver=syms[me], value=0.2)
    return cfg


def _phalanx(cx0, cy0, side):
    """Square formation on a 2-cell lattice anchored at (cx0, cy0)."""
    return [[cx0 + 2 * i, cy0 + 2 * j, 0]
            for i in range(side // 2) for j in range(side // 2)]


def generate_map(env, map_size, handles):
    """Two mirrored phalanxes facing each other across a 2*gap corridor,
    each sized to ~4% of the map's cells."""
    side = int(math.sqrt(map_size * map_size * 0.04)) * 2
    gap = 3
    top = (map_size - side) // 2
    anchors = (map_size // 2 - gap - side, map_size // 2 + gap)
    for h, cx0 in zip(handles, anchors):
        env.add_agents(h, method="custom", pos=_phalanx(cx0, top, side))


def _drop_block(env, handle, cx, cy, w=10, h=10):
    """Drop a w x h block of reinforcements centred on (cx, cy); cells that
    are off-map or occupied are skipped by add_agents."""
    half_w, half_h = w // 2, h // 2
    cells = [(cx + dx - half_w, cy + dy - half_h)
             for dx in range(w) for dy in range(h)]
    env.add_agents(handle, method="custom", pos=cells)


class BattleServer(BaseServer):
    """The player commands red (group 0); both sides are driven by DQN
    checkpoints when available.  Every ``add_interval`` frames the game
    pauses and a left-click drops red reinforcements at the cursor while
    blue receives a random drop — ``add_counter`` uses in total."""

    PLAYER = 0

    def __init__(self, path="save_model", epoch=None,
                 names=("trusty-battle-game-l", "trusty-battle-game-r"),
                 map_size=125, total_step=1000, add_counter=10,
                 add_interval=50, eps=0.05, device=None):
        env = GridWorld(load_config(map_size), device=device)
        handles = env.get_handles()
        teams = [
            _Team(handles[0],
                  DeepQNetwork(env, handles[0], names[0], memory_size=2 ** 10,
                               device=device),
                  names[0], RED),
            _Team(handles[1],
                  DeepQNetwork(env, handles[1], names[1], memory_size=2 ** 10,
                               device=device),
                  names[1], BLUE),
        ]
        self.loaded = [self._restore(t, path, epoch) for t in teams]

        env.reset()
        generate_map(env, map_size, handles)

        self.env = env
        self.teams = teams
        self.handles = handles
        self.models = [t.model for t in teams]
        self.eps = eps
        self.map_size = map_size
        self.total_step = total_step
        self.add_interval = add_interval
        self.add_counter = add_counter
        self.done = False

    @staticmethod
    def _restore(team, path, epoch):
        """Try the local save dir first, then the checkpoints bundled with
        the repo (analog of the reference's downloaded pretrained models,
        examples/show_battle_game.py:13-15) so the demo plays out of the
        box."""
        for root in (path, utility.bundled_model_dir()):
            ep = epoch if epoch is not None else latest_epoch(root, team.name)
            if ep is None:
                continue
            try:
                team.model.load(root, ep, team.name)
            except FileNotFoundError:
                continue
            print("loaded %s epoch %d from %s" % (team.name, ep, root))
            return True
        print("no checkpoint for %s: plays untrained "
              "(train with examples/train_battle_game.py)" % team.name)
        return False

    # ------------------------------------------------------------ simulation
    def _advance(self):
        """One env step: every team acts eps-greedily on its observation."""
        env = self.env
        for t in self.teams:
            obs = env.get_observation(t.handle)
            ids = env.get_agent_id(t.handle)
            env.set_action(
                t.handle,
                t.model.infer_action(obs, ids, "e_greedy", eps=self.eps))
        done = env.step()
        env.clear_dead()
        return done

    def _population(self, g):
        return self.env.get_num(self.teams[g].handle)

    def _pause_frame(self, frame_id):
        """Is this a recruitment pause (game waits for a click)?"""
        return (frame_id % self.add_interval == 0
                and frame_id < self.total_step and self.add_counter > 0)

    # ------------------------------------------------------- client protocol
    def get_info(self):
        return ((self.map_size, self.map_size), self.env._get_groups_info(),
                {"wall": self.env._get_walls_info()})

    def get_data(self, frame_id, x_range, y_range):
        if self.done:
            return None
        self.done = self._advance()
        return self.env._get_render_info(x_range, y_range)

    def add_agents(self, x, y, g):
        _drop_block(self.env, self.teams[g].handle, x, y)

    def get_map_size(self):
        return self.map_size, self.map_size

    def get_banners(self, frame_id, resolution):
        scoreline = (("%d" % self._population(0), RED),
                     (" vs ", BLACK),
                     ("%d" % self._population(1), BLUE))
        rows = [
            scoreline,
            (("%d chance(s) remained" % max(0, self.add_counter), BLACK),),
            (("%d / %d steps" % (frame_id, self.total_step), BLACK),),
        ]
        if self._pause_frame(frame_id):
            rows.append((("Press the left mouse button to add agents",
                          BLACK),))
        return rows

    def get_status(self, frame_id):
        if frame_id % self.add_interval == 0 and self.add_counter > 0:
            return False  # paused for recruitment
        if frame_id >= self.total_step or self.done:
            return None  # game over
        return True

    def keydown(self, frame_id, key, mouse_x, mouse_y):
        return False

    def mousedown(self, frame_id, pressed, mouse_x, mouse_y):
        if not (pressed[0] and self._pause_frame(frame_id) and not self.done):
            return False
        self.add_counter -= 1
        # the player reinforces red where clicked; blue gets a random drop
        _drop_block(self.env, self.teams[self.PLAYER].handle,
                    mouse_x, mouse_y)
        rx = np.random.randint(0, self.map_size - 1)
        ry = np.random.randint(0, self.map_size - 1)
        _drop_block(self.env, self.teams[1 - self.PLAYER].handle, rx, ry,
                    w=11, h=10)
        return True

    def get_endscreen(self, frame_id):
        if frame_id != self.total_step and not self.done:
            return []
        verdict = (" win! :)" if self._population(0) > self._population(1)
                   else " lose. :(")
        return [(("You", RED), (verdict, BLACK))]
