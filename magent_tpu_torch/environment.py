"""Abstract environment base (a copy of ``magent_tpu/environment.py``;
reference: python/magent/environment.py).

Kept for API parity: the stateful :class:`~magent_tpu_torch.env.GridWorld`
implements this surface."""


class Environment:
    def __init__(self):
        pass

    def reset(self):
        pass

    def get_observation(self, handle):
        pass

    def set_action(self, handle, actions):
        pass

    def step(self):
        pass

    def render(self):
        pass

    def get_reward(self, handle):
        pass

    def render_next_file(self):
        pass

    def get_num(self, handle):
        pass

    def get_action_space(self, handle):
        pass

    def get_view_space(self, handle):
        pass

    def get_feature_space(self, handle):
        pass
