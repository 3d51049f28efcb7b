"""Arrange demo: agents swarm onto absorbing goal markers that spell a
message rendered from the 8x8 pixel font.

Port of ``magent_tpu/renderer/server/arrange_server.py``: capability
parity with the reference's arrange game (reference:
python/magent/renderer/server/arrange_server.py) through the
:class:`BaseServer` contract.  Goal markers are a ``can_absorb`` agent
type; colliding agents are absorbed (Map.cc:340-353) and light the marker
up — the absorbed markers are exactly the ones the replay/live renderers
draw (RenderGenerator.cc:137-152).  The reference's maze decoration is
omitted; glyph layout is computed in one pass by :func:`_message_pixels`.
The world (and a loaded net) live on ``device`` (``None``: the GPU, raising
without one).
"""

import numpy as np

from ... import gridworld
from ...builtin.rule_model import RandomActor
from ...builtin.torch_model import DeepQNetwork, latest_epoch
from ...env import GridWorld
from ...utility import FontProvider

from .base_server import BaseServer

BLACK = (0, 0, 0)


def load_config(map_size):
    """Arrange config: absorbing goal pixels + starving seeker agents
    rewarded for colliding into a goal (parameter table is the contract
    with examples/train_arrange.py checkpoints)."""
    gw = gridworld
    cfg = gw.Config()
    cfg.set({"map_width": map_size, "map_height": map_size,
             "minimap_mode": True, "embedding_size": 12})

    goal = cfg.register_agent_type(
        "goal", {'width': 1, 'length': 1, 'can_absorb': True})
    agent = cfg.register_agent_type(
        "agent",
        {'width': 1, 'length': 1, 'hp': 10, 'speed': 2,
         'view_range': gw.CircleRange(6),
         'damage': 2, 'step_recover': -10.0 / 400,
         'step_reward': 0})

    g_goal = cfg.add_group(goal)
    g_agent = cfg.add_group(agent)
    seeker = gw.AgentSymbol(g_agent, 'any')
    marker = gw.AgentSymbol(g_goal, 'any')
    cfg.add_reward_rule(gw.Event(seeker, 'collide', marker),
                        receiver=seeker, value=10)
    return cfg


def _wrap(messages, width=8):
    """Split each message into lines of at most ``width`` glyphs."""
    return [msg[i : i + width]
            for msg in messages for i in range(0, len(msg), width)]


def _message_pixels(messages, font, map_size):
    """All lit font pixels of the (centred) message block, as (x, y)
    cells."""
    lines = _wrap(messages)
    cells = []
    y0 = (map_size - len(lines) * font.height) // 2
    for row, line in enumerate(lines):
        x0 = (map_size - len(line) * font.width) // 2
        for col, ch in enumerate(line):
            glyph = font.get(ch)
            cells.extend(
                [x0 + col * font.width + j, y0 + row * font.height + i]
                for i in range(font.height) for j in range(font.width)
                if glyph[i][j] == 1)
    return cells


def generate_map(env, map_size, goal_handle, agent_handle, messages, font,
                 agent_density=0.02):
    env.add_agents(goal_handle, method="custom",
                   pos=_message_pixels(messages, font, map_size))
    env.add_agents(agent_handle, method="random",
                   n=int(map_size * map_size * agent_density))


def _true_stay_action(spec, slot):
    """The (0, 0) move index for ``slot``'s group.  Goals must STAY PUT:
    action 0 is the (0,-1) north move in the row-major move numbering,
    which would drift the glyph pixels up every step (the reference never
    sets goal actions; this engine consumes last_action for every active
    agent).  The zero-padded tail of the move tables must not be mistaken
    for a real (0,0) move, so the index is checked against turn_base (the
    spec's tables are host NumPy)."""
    sdx = spec.s_move_dx[slot]
    sdy = spec.s_move_dy[slot]
    stay = int(np.flatnonzero((sdx == 0) & (sdy == 0))[0])
    assert stay < int(spec.s_turn_base[slot]), \
        "goal type's move range has no true (0,0) stay"
    return stay


class ArrangeServer(BaseServer):
    def __init__(self, path="save_model", epoch=None, name="arrange",
                 messages=None, map_size=100, total_step=1000, eps=0.15,
                 font_file="data/font_8x8/basic.txt", device=None):
        env = GridWorld(load_config(map_size), device=device)
        goal_handle, agent_handle = env.get_handles()
        self.model = self._restore(env, agent_handle, path, epoch, name,
                                   device)

        env.reset()
        generate_map(env, map_size, goal_handle, agent_handle,
                     messages or ["MAGENT"], FontProvider(font_file))

        self.env = env
        self.goal_handle = goal_handle
        self.agent_handle = agent_handle
        self._goal_stay = _true_stay_action(
            env.spec, env.spec.groups[goal_handle.value].offset)
        self.eps = eps
        self.map_size = map_size
        self.total_step = total_step
        self.done = False

    @staticmethod
    def _restore(env, handle, path, epoch, name, device):
        ep = epoch if epoch is not None else latest_epoch(path, name)
        if ep is not None:
            try:
                model = DeepQNetwork(env, handle, name, memory_size=2 ** 10,
                                     device=device)
                model.load(path, ep, name)
                print("loaded %s epoch %d" % (name, ep))
                return model
            except FileNotFoundError:
                pass
        print("no checkpoint for %s: agents act randomly "
              "(train with examples/train_arrange.py)" % name)
        return RandomActor(env, handle)

    # ------------------------------------------------------------ simulation
    def _advance(self):
        env = self.env
        obs = env.get_observation(self.agent_handle)
        ids = env.get_agent_id(self.agent_handle)
        env.set_action(
            self.agent_handle,
            self.model.infer_action(obs, ids, "e_greedy", eps=self.eps))
        env.set_action(self.goal_handle, np.full(
            env.get_num(self.goal_handle), self._goal_stay, np.int32))
        done = env.step()
        env.clear_dead()
        return done

    def _absorbed_count(self):
        return int(self.env._host("absorbed", self.goal_handle).sum())

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
        block = [(x + dx, y + dy)
                 for dx in range(-2, 3) for dy in range(-2, 3)]
        self.env.add_agents(self.agent_handle, method="custom", pos=block)

    def get_map_size(self):
        return self.map_size, self.map_size

    def get_banners(self, frame_id, resolution):
        return [
            (("arranged %d / %d" % (self._absorbed_count(),
                                    self.env.get_num(self.goal_handle)),
              BLACK),),
            (("%d / %d steps" % (frame_id, self.total_step), BLACK),),
        ]

    def get_status(self, frame_id):
        if frame_id >= self.total_step or self.done:
            return None
        return True

    def keydown(self, frame_id, key, mouse_x, mouse_y):
        return False

    def mousedown(self, frame_id, pressed, mouse_x, mouse_y):
        if pressed[0]:
            self.add_agents(mouse_x, mouse_y, 1)
            return True
        return False

    def get_endscreen(self, frame_id):
        if frame_id < self.total_step and not self.done:
            return []
        return [(("Done, %d markers filled" % self._absorbed_count(),
                  BLACK),)]
