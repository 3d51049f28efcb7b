"""Random actor (port of ``magent_tpu/builtin/rule_model/random.py``;
reference: python/magent/builtin/rule_model/random.py)."""

import numpy as np

from ...model import BaseModel


class RandomActor(BaseModel):
    def __init__(self, env, handle, *args, **kwargs):
        super().__init__(env, handle)
        self.action_space = env.get_action_space(handle)

    def infer_action(self, obs, *args, **kwargs):
        num = len(obs[0])
        actions = np.random.randint(low=0, high=self.action_space[0],
                                    size=num, dtype=np.int32)
        return actions
