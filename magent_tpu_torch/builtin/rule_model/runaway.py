"""Run-away rule policy (port of
``magent_tpu/builtin/rule_model/runaway.py``; reference:
src/temp_c_booster.cc:14-37 via rule_model/runaway.py): if a predator is
visible just behind, move back, else move forward."""

import numpy as np

from ...model import BaseModel


class RunawayPrey(BaseModel):
    def __init__(self, env, handle, away_handle, *args, **kwargs):
        super().__init__(env, handle)
        sp = env.spec
        perm = sp.channel_perm(handle.value)
        av = int(away_handle.value if hasattr(away_handle, "value") else away_handle)
        self.away_channel = int(perm[sp.group2channel(av)])
        self.attack_base, _ = env.get_view2attack(handle)
        self.move_back = 4  # action id of "one step back" in the reference booster

    def infer_action(self, obs, *args, **kwargs):
        views, _ = obs
        n, h, w, _ = views.shape
        window = views[:, h - 3 : h, w // 2 - 1 : w // 2 + 2, self.away_channel]
        found = (window > 0.5).reshape(n, -1).any(axis=1)
        return np.where(found, self.move_back, self.move_back + 1).astype(np.int32)
