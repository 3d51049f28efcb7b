"""The port's ``examples.eval_checkpoint`` and ``examples.tournament``
against ``scripts/eval_checkpoint.py`` and ``scripts/tournament.py``
(loaded with ``importlib``, run through their ``main`` with ``sys.argv``
set) on the CPU, on small battle maps for a few steps: the printed
records (each game's survivors, the pairings' scores and the standings)
equal the JAX script's.  Both load the trusty checkpoints of
``data/models`` (the JAX package's files); eval_checkpoint's untrained
opponent takes the JAX script's flax init (``set_params``), its random
opponent NumPy's stream reseeded before each run.  A near-tie between a
model's top two Q values could flip an action; the maps and depths here
meet none."""

import io
import os
import shutil
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

from magent_tpu_torch.examples import eval_checkpoint, tournament

from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_script_cases import REPO, jax_cli_defaults, jax_script
from _torch_train_checks import flatten_tree

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODELS = os.path.join(REPO, "data", "models")


@pytest.mark.parametrize("name,mod", [("eval_checkpoint", eval_checkpoint),
                                      ("tournament", tournament)])
def test_cli_defaults_match_the_jax_script(monkeypatch, name, mod):
    jm = jax_script("scripts/%s.py" % name)
    want = jax_cli_defaults(jm, monkeypatch)
    got = vars(mod.cli().parse_args([]))
    assert got.pop("device") is None
    assert got == want


def _printed(fn, *args):
    out = io.StringIO()
    with redirect_stdout(out):
        result = fn(*args)
    return out.getvalue(), result


@pytest.mark.parametrize("opponent", ["random", "untrained"])
def test_eval_checkpoint_matches_jax(monkeypatch, opponent):
    jm = jax_script("scripts/eval_checkpoint.py")
    made = []

    class Recorded(jm.DeepQNetwork):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jm, "DeepQNetwork", Recorded)
    argv = ["--savedir", MODELS, "--name", "trusty-battle-game-l",
            "--map_size", "24", "--n_games", "2", "--max_steps", "6",
            "--opponent", opponent]
    monkeypatch.setattr(sys, "argv", ["eval_checkpoint.py"] + argv)
    np.random.seed(3)
    want, _ = _printed(jm.main)

    args = eval_checkpoint.cli().parse_args(argv + ["--device", "cpu"])
    ex = eval_checkpoint.setup(args)
    if opponent == "untrained":
        ex.opponent.set_params(flatten_tree(jax.device_get(made[1].params)))
    np.random.seed(3)
    got, games = _printed(eval_checkpoint.play, ex, args)
    assert "loaded trusty-battle-game-l epoch 0" in want
    assert got == want.split("\n", 1)[1]
    assert len(games) == 2 and all(g[2] == 6 for g in games)


def test_tournament_matches_jax(monkeypatch, tmp_path):
    """Two epochs (the trusty left and right checkpoints saved as epochs 0
    and 3), map 24, two games of 6 steps per pairing."""
    d = tmp_path / "b"
    d.mkdir()
    for side, epoch in (("l", 0), ("r", 3)):
        shutil.copy(os.path.join(MODELS, "trusty-battle-game-%s" % side,
                                 "tfdqn_0.npz"), d / ("tfdqn_%d.npz" % epoch))
    argv = ["--savedir", str(tmp_path), "--name", "b", "--map_size", "24",
            "--n_game", "2", "--max_steps", "6", "--pick_every", "1"]
    jm = jax_script("scripts/tournament.py")
    monkeypatch.setattr(sys, "argv", ["tournament.py"] + argv)
    want, _ = _printed(jm.main)
    got, results = _printed(tournament.main, argv + ["--device", "cpu"])
    assert got == want
    assert list(results) == [(0, 3)]
    assert "checkpoint epochs: [0, 3]" in got
    assert tournament.extract_checkpoints(str(tmp_path), "b", 0, 1) == \
        jm.extract_checkpoints(str(tmp_path), "b", 0, 1) == [0, 3]
