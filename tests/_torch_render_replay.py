"""Record and replay for the render paths, shared by the card tests and
``chip_smoke.py`` (the port and NumPy only): a world driven on one device
records every call made to it; the same calls made on a world of the other
device must write the same replay files, byte for byte.  For the live
battle, the actions each model returned are recorded and played back in
place of the other server's models, so that the comparison holds the env
and the render, not the nets."""

import os
import time

import numpy as np


def _copy(value):
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, (list, tuple)):
        return type(value)(_copy(v) for v in value)
    if isinstance(value, dict):
        return {k: _copy(v) for k, v in value.items()}
    return value


class Recorder:
    """Forwards every method call to ``env`` and logs it in ``log`` as
    ``(name, args, kwargs)``, NumPy arguments copied; other attributes
    pass through."""

    def __init__(self, env):
        self.env = env
        self.log = []

    def __getattr__(self, name):
        attr = getattr(self.env, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            self.log.append((name, _copy(args), _copy(kwargs)))
            return attr(*args, **kwargs)

        return call


def replay(log, env, render_dir):
    """Make the calls of a :class:`Recorder`'s ``log`` on ``env``, with
    ``set_render_dir`` pointed at ``render_dir`` -> their results."""
    out = []
    for name, args, kwargs in log:
        if name == "set_render_dir":
            args = (render_dir,)
        out.append(getattr(env, name)(*args, **kwargs))
    return out


def dump_differences(a, b):
    """The file names found in only one of the directories ``a`` and
    ``b``, or in both with other bytes."""
    fa, fb = set(os.listdir(a)), set(os.listdir(b))
    out = sorted(fa ^ fb)
    for f in sorted(fa & fb):
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            if x.read() != y.read():
                out.append(f)
    return out


def record_actions(server, clock=None):
    """Wrap each team's model of a ``BattleServer``: the actions of every
    ``infer_action`` call are appended to the returned list, and with
    ``clock`` (a ``collections.Counter``) its seconds to
    ``clock["inference"]``."""
    tape = []
    for team in server.teams:
        infer = team.model.infer_action

        def wrapped(*args, _infer=infer, **kwargs):
            t0 = time.perf_counter()
            acts = _infer(*args, **kwargs)
            if clock is not None:
                clock["inference"] += time.perf_counter() - t0
            tape.append(acts.copy())
            return acts

        team.model.infer_action = wrapped
    return tape


def play_actions(server, tape):
    """Replace each team's model's ``infer_action`` of a ``BattleServer``
    by the recorded actions, in the order they were recorded."""
    pos = [0]

    def play(obs, *args, **kwargs):
        acts = tape[pos[0]]
        pos[0] += 1
        if len(acts) != len(obs[0]):
            raise AssertionError("recorded %d actions for %d agents" % (
                len(acts), len(obs[0])))
        return acts

    for team in server.teams:
        team.model.infer_action = play


def frames_equal(got, want):
    """Two ``get_data`` results ``(agents, events)``: equal dicts in equal
    order and equal int32 event arrays."""
    return (got[0] == want[0] and list(got[0]) == list(want[0])
            and got[1].dtype == want[1].dtype == np.int32
            and np.array_equal(got[1], want[1]))
