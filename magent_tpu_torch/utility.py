"""Utilities: episode replay buffer, exploration schedulers, eval-set
sampling, logging and the bundled checkpoints (port of
``magent_tpu/utility.py``; reference: python/magent/utility.py).

All host Python and NumPy.  The NumPy calls are the JAX package's, in its
order (``EpisodesBuffer.record_step``'s ``np.random.permutation``,
``sample_observation``'s ``np.random.choice``), so that one NumPy seed gives
both packages the same records.  The reference's ``download_file`` and
``download_model`` are not here: the port makes no network access, and
``check_model`` raises where the JAX package would download."""

from __future__ import annotations

import bisect
import collections
import logging
import math
import os

import numpy as np


class EpisodesBufferEntry:
    """Per-agent episode record (reference: utility.py:15-30)."""

    def __init__(self):
        self.views = []
        self.features = []
        self.actions = []
        self.rewards = []
        self.terminal = False

    def append(self, view, feature, action, reward, alive):
        self.views.append(view.copy())
        self.features.append(feature.copy())
        self.actions.append(action)
        self.rewards.append(reward)
        if not alive:
            self.terminal = True


class EpisodesBuffer:
    """Episode store keyed by agent id, one entry per agent (reference:
    utility.py:33-75): at most ``capacity`` distinct episodes; once full,
    only already-tracked agents keep recording; admission order is
    randomized so the kept subset is an unbiased sample of the
    population."""

    def __init__(self, capacity):
        self.buffer = {}
        self.capacity = capacity
        self.is_full = False

    def record_step(self, ids, obs, acts, rewards, alives):
        views, feats = obs
        order = (range(len(ids)) if self.is_full
                 else np.random.permutation(len(ids)))
        for k in order:
            entry = self.buffer.get(ids[k])
            if entry is None:
                if self.is_full:
                    continue
                entry = EpisodesBufferEntry()
                self.buffer[ids[k]] = entry
                self.is_full = len(self.buffer) >= self.capacity
            entry.append(views[k], feats[k], acts[k], rewards[k], alives[k])

    def reset(self):
        self.buffer = {}
        self.is_full = False

    def episodes(self):
        return self.buffer.values()


# ---------------------------------------------------------------- schedulers
def exponential_decay(now_step, total_step, final_value, rate):
    """1.0 -> ``final_value`` along ``exp(k * step^rate)``, floored at
    final_value (reference: utility.py:79-82)."""
    frac = (now_step ** rate) / (total_step ** rate)
    return max(final_value, math.exp(math.log(final_value) * frac))


def linear_decay(now_step, total_step, final_value):
    """1.0 -> ``final_value`` linearly over ``total_step`` steps, floored
    (reference: utility.py:85-88)."""
    return max(final_value,
               1.0 - now_step * (1.0 - final_value) / total_step)


def piecewise_decay(now_step, anchor, anchor_value):
    """Piecewise-linear interpolation through ``(anchor, anchor_value)``
    knots, clamped at both ends (reference: utility.py:91-111)."""
    if now_step >= anchor[-1]:
        return anchor_value[-1]
    i = bisect.bisect_right(anchor, now_step)
    if i == 0:
        return anchor_value[0]
    x0, x1 = anchor[i - 1], anchor[i]
    y0, y1 = anchor_value[i - 1], anchor_value[i]
    return y0 + (now_step - x0) * (y1 - y0) / (x1 - x0)


# ---------------------------------------------------------- eval observations
def sample_observation(env, handles, n_obs=-1, step=-1):
    """Sample observations with random actors for evaluation
    (reference: utility.py:115-178)."""
    from .builtin.rule_model import RandomActor

    models = [RandomActor(env, handle) for handle in handles]

    n = len(handles)
    views = [[] for _ in range(n)]
    features = [[] for _ in range(n)]

    done = False
    step_ct = 0
    while not done:
        obs = [env.get_observation(handle) for handle in handles]
        ids = [env.get_agent_id(handle) for handle in handles]

        for i in range(n):
            act = models[i].infer_action(obs[i], ids[i])
            env.set_action(handles[i], act)

        done = env.step()
        env.clear_dead()

        for i in range(n):
            views[i].append(obs[i][0])
            features[i].append(obs[i][1])

        if step != -1 and step_ct > step:
            break
        step_ct += 1

    for i in range(n):
        views[i] = np.concatenate(views[i]).reshape(
            (-1,) + env.get_view_space(handles[i]))
        features[i] = np.concatenate(features[i]).reshape(
            (-1,) + env.get_feature_space(handles[i]))

    if n_obs != -1:
        for i in range(n):
            idx = np.random.choice(np.arange(views[i].shape[0]), n_obs)
            views[i] = views[i][idx]
            features[i] = features[i][idx]

    return [(v, f) for v, f in zip(views, features)]


# -------------------------------------------------------------------- logging
def init_logger(filename):
    """tee INFO logs to <filename>.log and console (reference:
    utility.py:181-192)"""
    logging.basicConfig(level=logging.INFO, filename=filename + ".log")
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    logging.getLogger('').addHandler(console)


def rec_round(x, ndigits=2):
    """round recursively (reference: utility.py:195-206); numpy scalars are
    cast to plain floats so log lines print ``-825.38``, not
    ``np.float32(-825.38)``"""
    if isinstance(x, collections.abc.Iterable):
        return [rec_round(item, ndigits) for item in x]
    return round(float(x), ndigits)


def has_gpu():
    """whether a CUDA device is available"""
    import torch

    return torch.cuda.is_available()


# ------------------------------------------------------- pretrained models
def bundled_model_dir():
    """Directory of the pretrained checkpoints shipped with the repository
    (``data/models``: ``trusty-battle-game-l`` and ``-r``, ``tfdqn_0.npz``
    each, in the flax layout both packages read)."""
    return os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "data", "models"))


# the reference's pretrained archives (utility.py:242-270): the files each
# name needs, relative to the working directory
_MODEL_FILES = {
    "against": ("save_model/against/dqn_0.npz",),
    "battle-game": ("save_model/trusty-battle-game-l/dqn_0.npz",
                    "save_model/trusty-battle-game-r/dqn_0.npz"),
    "arrange": ("save_model/arrange/dqn_10.npz",),
}


def check_model(name):
    """Ensure a named pretrained model is present (reference:
    utility.py:242-270): ``RuntimeError("Unknown model name")`` for a name
    it does not know, nothing when the files exist, and a ``RuntimeError``
    naming :func:`bundled_model_dir` when they are absent (the reference
    downloads them; the port makes no network access)."""
    if name not in _MODEL_FILES:
        raise RuntimeError("Unknown model name")
    missing = [f for f in _MODEL_FILES[name] if not os.path.exists(f)]
    if missing:
        raise RuntimeError(
            "pretrained model %r is missing (%s) and is not downloaded; the "
            "repository ships the battle-game checkpoints in %s, and the "
            "examples train the others locally"
            % (name, ", ".join(missing), bundled_model_dir()))


class FontProvider:
    """8x8 pixel font for the arrange demo (reference: utility.py:271-305)."""

    def __init__(self, filename):
        data = []
        with open(filename) as fin:
            for line in fin.readlines():
                char = []
                for x in line.split(','):
                    char.append(int(x, 0))
                data.append(char)

        height, width = 8, 8
        expand_data = []
        for char in data:
            expand_char = [[0 for _ in range(width)] for _ in range(height)]
            for i in range(width):
                for j in range(height):
                    if char[i] & (1 << j):
                        expand_char[i][j] = 1
            expand_data.append(expand_char)

        self.data = expand_data
        self.width = width
        self.height = height

    def get(self, i):
        if isinstance(i, int):
            return self.data[i]
        return self.data[ord(i)]
