"""Rush-at-prey rule policy (port of
``magent_tpu/builtin/rule_model/rush.py``).

Vectorized numpy port of the reference's OpenMP C booster
(reference: src/temp_c_booster.cc:39-83 via rule_model/rush.py): scan the view
for enemies/food, attack through the view2attack table if in range, else step
forward, else move randomly.
"""

import numpy as np

from ...model import BaseModel


class RushPredator(BaseModel):
    def __init__(self, env, handle, attack_handle, *args, **kwargs):
        super().__init__(env, handle)
        self.attack_base, self.view2attack = env.get_view2attack(handle)

        if attack_handle is not None and attack_handle != -1:
            # observed channel of the target group's "has" layer
            sp = env.spec
            perm = sp.channel_perm(handle.value)
            av = int(attack_handle.value if hasattr(attack_handle, "value") else attack_handle)
            self.attack_channel = int(perm[sp.group2channel(av)])
        else:
            self.attack_channel = env.get_view_space(handle)[2] - 2

        # the reference wrapper passes 100.0, disabling the feature gate for
        # every agent (rule_model/rush.py:32 -> temp_c_booster.cc:50); a
        # small default would freeze every odd-id agent (feature[0] is the
        # low bit of the id embedding)
        self.threshold = kwargs.get("threshold", 100.0)

    def infer_action(self, obs, *args, **kwargs):
        views, features = obs
        n, h, w, _ = views.shape
        acts = np.empty(n, dtype=np.int32)

        enemy = views[:, :, :, self.attack_channel] > 0.5
        food = views[:, :, :, 1] > 0.5 if views.shape[3] > 1 else np.zeros_like(enemy)
        target = enemy | food

        v2a = self.view2attack  # [h, w], -1 when not attackable
        attackable = target & (v2a[None, :, :] != -1)

        below = features[:, 0] < self.threshold
        flat = attackable.reshape(n, -1)
        found_attack = flat.any(axis=1)
        # first target in row-major scan order (matches the reference loop)
        first = np.argmax(flat, axis=1)
        att_action = v2a.reshape(-1)[first]

        found_any = target.reshape(n, -1).any(axis=1)
        wall_ahead = views[:, h - 1, w // 2, 0] > 0.5

        rand_moves = np.random.randint(0, self.attack_base, size=n)
        acts[:] = rand_moves
        fwd = below & found_any & ~found_attack & ~wall_ahead
        acts[fwd] = 0
        hit = below & found_attack
        acts[hit] = self.attack_base + att_action[hit]
        return acts
