"""Food-gathering rule policy (port of
``magent_tpu/builtin/rule_model/rushgather.py``; reference:
src/temp_c_booster.cc:115-181 via rule_model/rushgather.py): attack adjacent
food, walk toward visible food, otherwise navigate using the minimap
channel."""

import numpy as np

from ...model import BaseModel


def _get_action(d_row, d_col, stride):
    """Displacement -> move action id for the gather agent's 13-move space
    (reference: temp_c_booster.cc:85-113)."""
    if d_row < 0:
        if d_col < 0:
            return 1
        if d_col == 0:
            return 0 if stride else 2
        return 3
    if d_row == 0:
        if d_col < 0:
            return 4 if stride else 5
        if d_col == 0:
            return 6
        return 8 if stride else 7
    if d_col < 0:
        return 9
    if d_col == 0:
        return 12 if stride else 10
    return 11


class RushGatherer(BaseModel):
    def __init__(self, env, handle, *args, **kwargs):
        super().__init__(env, handle)
        self.env = env
        self.handle = handle
        self.attack_base, self.view2attack = env.get_view2attack(handle)
        self.view_size = env.get_view_space(handle)

    def infer_action(self, obs, *args, **kwargs):
        views, _ = obs
        n, h, w, _ = views.shape
        acts = np.empty(n, dtype=np.int32)
        v2a = self.view2attack

        for i in range(n):
            obs_i = views[i]
            action = -1

            att, moves = [], []
            food_cells = np.argwhere(np.abs(obs_i[:, :, 4] - 1.0) < 1e-10)
            for (row, col) in food_cells:
                if v2a[row, col] != -1:
                    att.append(v2a[row, col] + self.attack_base)
                else:
                    d_row, d_col = row - h // 2, col - w // 2
                    if d_row == d_col and abs(d_col) == 1:
                        if np.random.randint(2):
                            d_row = 0
                        else:
                            d_col = 0
                    moves.append((d_row, d_col))
            if att:
                action = att[np.random.randint(len(att))]
            elif moves:
                action = _get_action(moves[0][0], moves[0][1], False)

            if action == -1:  # minimap navigation
                self_cells = np.argwhere(obs_i[:, :, 3] > 1.0)
                my = self_cells[0] if len(self_cells) else (h // 2, w // 2)
                cand = []
                mm = obs_i[:, :, 6]
                for (row, col) in np.argwhere(mm > 0.0):
                    cand.append((mm[row, col], (row - my[0], col - my[1])))
                cand.sort(reverse=True)
                if cand:
                    disp = cand[np.random.randint(len(cand))][1]
                    action = _get_action(disp[0], disp[1], True)
                    if action == 6:
                        action = np.random.randint(self.attack_base)
                else:
                    action = np.random.randint(self.attack_base)

            acts[i] = action
        return acts
