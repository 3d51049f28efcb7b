"""The port's ``examples.train_evidence`` and ``examples.tournament_pursuit``
against ``scripts/train_evidence.py`` and ``scripts/tournament_pursuit.py``
(loaded with ``importlib``, run through their ``main`` with ``sys.argv``
set) on the CPU, each game at map 20, B=2, 4 rounds of 2 train steps of
rollout 3, eval every 2 rounds over 4 steps, generations saved every 2.

The port starts from the JAX script's flax init (its saved generation 0,
read with ``params_from_flax``).  Held, within the trainers' tolerances
(PERF.md §2): the logged ``round`` lines (loss and reward, each printed
to 4 decimals: within one unit of the last printed digit), the GEN and
EVAL lines (printed to 5 and 4 decimals: the same rule), and every saved
generation: generation 0 bit for bit, then each parameter within
``(2 lr + 0.2 lr)`` per train step of JAX's (Adam's first steps move a
parameter by about ``lr`` per step; a gradient within rounding of 0 may
take the other sign).  tournament_pursuit: each package's script over
each package's generations prints the same catch lines."""

import ast
import io
import logging
import os
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from magent_tpu_torch.builtin.torch_model import DQNNet, params_from_flax
from magent_tpu_torch.examples import train_evidence, tournament_pursuit
from magent_tpu_torch.parallel import VecGridWorld

from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_script_cases import REPO, jax_cli_defaults, jax_script

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR = 1e-4
# 8 envs: the JAX script's mesh spans the test's 8 virtual CPU devices.
# gather runs smaller: XLA's CPU convolutions over its agents' wide views
# take ~90 s per call of the map-20 run
SIZES = {"pursuit": (20, 4, 2), "tiger": (20, 4, 2), "gather": (12, 2, 1)}


def argv_of(game):
    """(map, rounds, steps per call) -> the scripts' arguments: eval and
    save after every call."""
    m, n_round, spc = SIZES[game]
    return ["--map_size", str(m), "--n_envs", "8", "--n_round", str(n_round),
            "--rollout_len", "3", "--steps_per_call", str(spc),
            "--eval_steps", "4", "--eval_every", str(spc), "--save_every",
            str(spc)]


def test_cli_defaults_match_the_jax_script(monkeypatch):
    jm = jax_script("scripts/train_evidence.py")
    seen = jax_cli_defaults(jm, monkeypatch, ["--game", "tiger"])
    got = vars(train_evidence.cli().parse_args(["--game", "tiger"]))
    assert got.pop("device") is None
    assert got == seen
    assert sorted(train_evidence.SETUPS) == sorted(jm.SETUPS)
    tp = vars(tournament_pursuit.cli().parse_args([]))
    assert tp.pop("device") is None
    assert tp == dict(name="pursuit-gen", savedir="save_model", map_size=64,
                      n_envs=16, eval_steps=200, eps=0.05, pick_every=1)


@pytest.mark.parametrize("game", ["pursuit", "gather", "tiger"])
def test_setups_match_jax(game, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    jm = jax_script("scripts/train_evidence.py")
    for m in (20, 64):
        want = jm.SETUPS[game](m)
        got = train_evidence.SETUPS[game](m)
        assert got[1:] == want[1:]
        tspec = VecGridWorld(got[0], got[1], 1, placements=got[2],
                             device="cpu").spec
        assert [g.cap for g in tspec.groups] == got[1]


def _run_jax(jm, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train_evidence.py"] + argv)
    out = io.StringIO()
    with redirect_stdout(out):
        jm.main()
    return out.getvalue()


def _rounds(records):
    """The logged ``round`` lines -> [(k, loss list, reward list)]."""
    out = []
    for r in records:
        m = re.match(r"round (\d+)\t loss: (\[.*\])\t reward: (\[.*\])",
                     r.getMessage())
        if m:
            out.append((int(m.group(1)), ast.literal_eval(m.group(2)),
                        ast.literal_eval(m.group(3))))
    return out


def _numbers(text, pattern):
    return [tuple(float(v) for v in m)
            for m in re.findall(pattern, text)]


def _gens(path):
    return {int(re.match(r"tfdqn_(\d+)\.npz", f).group(1)): dict(np.load(
        os.path.join(path, f))) for f in os.listdir(path)}


@pytest.mark.parametrize("game", ["pursuit", "gather", "tiger"])
def test_training_matches_jax(game, tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", list(sys.path))
    caplog.set_level(logging.INFO)
    jm = jax_script("scripts/train_evidence.py")
    argv = argv_of(game)
    m, n_round, spc = SIZES[game]
    jtext = _run_jax(jm, ["--game", game, "--name", "jax"] + argv,
                     monkeypatch)
    jrounds = _rounds(caplog.records)
    caplog.clear()

    cfg, caps, placements, train_groups, hero = train_evidence.SETUPS[game](
        m)
    spec = VecGridWorld(cfg, caps, 8, placements=placements,
                        device="cpu").spec
    nets = []
    for g in range(spec.n_groups):
        net = None
        if g in train_groups:
            net = DQNNet(spec.view_space(g), spec.feature_size(g),
                         spec.groups[g].type.n_action)
            net.load_state_dict(params_from_flax(_gens(
                "save_model/jax-g%d" % g)[0]))
        nets.append(net)
    out = io.StringIO()
    with redirect_stdout(out):
        got = train_evidence.main(["--game", game, "--name", "port",
                                   "--device", "cpu"] + argv, nets=nets)
    text = out.getvalue()
    rounds = _rounds(caplog.records)

    gens = list(range(0, n_round + 1, spc))
    assert [r[0] for r in rounds] == [r[0] for r in jrounds] == gens[:-1]
    for (_, loss, rew), (_, jloss, jrew) in zip(rounds, jrounds):
        np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-4)
        np.testing.assert_allclose(rew, jrew, rtol=0, atol=1e-4)
    gen = r"GEN \w+ round (\d+): eval=(-?[\d.]+) evalq=(-?[\d.]+) " \
          r"targetq=(-?[\d.]+)"
    mine, want = _numbers(text, gen), _numbers(jtext, gen)
    assert len(mine) == len(want) == len(gens) - 1
    np.testing.assert_allclose(mine, want, rtol=0, atol=1e-4)
    ev = r"EVAL \w+: trained=(-?[\d.]+) untrained=(-?[\d.]+)"
    assert len(_numbers(text, ev)) == 1
    np.testing.assert_allclose(_numbers(text, ev), _numbers(jtext, ev),
                               rtol=0, atol=1e-5)
    assert (got["trained"], got["untrained"]) == pytest.approx(
        _numbers(jtext, ev)[0], abs=1e-5)
    for g in train_groups:
        mine, want = _gens("save_model/port-g%d" % g), _gens(
            "save_model/jax-g%d" % g)
        assert sorted(mine) == sorted(want) == gens
        for k in want:
            assert set(mine[k]) == set(want[k])
            for name in want[k]:
                diff = np.abs(mine[k][name] - want[k][name]).max()
                # generation k: after k train steps
                assert diff <= 2.2 * LR * k, (g, k, name, diff)
    if game == "pursuit":
        _cross_play(monkeypatch)


def _cross_play(monkeypatch):
    """Both tournament_pursuit scripts over both packages' generations:
    the same catch lines."""
    jt = jax_script("scripts/tournament_pursuit.py")
    monkeypatch.setattr(sys, "path", [os.path.join(REPO, "scripts")]
                        + sys.path)
    tp_argv = ["--map_size", "20", "--n_envs", "8", "--eval_steps", "4"]
    catch = r"pred gen +(\d+) vs prey gen +(\d+) -> catch (-?[\d.]+)"
    for name in ("jax", "port"):
        monkeypatch.setattr(sys, "argv", ["tournament_pursuit.py", "--name",
                                          name] + tp_argv)
        out = io.StringIO()
        with redirect_stdout(out):
            jt.main()
        want = _numbers(out.getvalue(), catch)
        out = io.StringIO()
        with redirect_stdout(out):
            gens, matrix = tournament_pursuit.main(
                ["--name", name, "--device", "cpu"] + tp_argv)
        got = _numbers(out.getvalue(), catch)
        assert gens == [0, 2, 4] and len(want) == 9
        assert got == want, name
        assert matrix.shape == (3, 3)


class _Built(Exception):
    pass


@pytest.mark.parametrize("game", ["pursuit", "gather", "tiger"])
def test_factory_arguments_match_jax(game, monkeypatch, tmp_path):
    """The VecGridWorld and train-loop factory calls of both scripts at
    their defaults (each stops at its factory)."""
    import magent_tpu.parallel as jpar

    from magent_tpu_torch.parallel import VecGridWorld as TVec

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", list(sys.path))
    jm = jax_script("scripts/train_evidence.py")
    seen = {}

    def capture(side, real_vec):
        def vec(cfg, caps, n_envs, placements=None, **kw):
            seen[side, "venv"] = (caps, n_envs, placements)
            if side == "jax":
                return real_vec(cfg, caps, n_envs=n_envs,
                                placements=placements)
            return real_vec(cfg, caps, n_envs=n_envs, placements=placements,
                            device="cpu")

        def loop(venv, *a, **kw):
            seen[side, "loop"] = kw
            raise _Built
        return vec, loop

    jvec, jloop = capture("jax", jpar.VecGridWorld)
    monkeypatch.setattr(jpar, "VecGridWorld", jvec)
    monkeypatch.setattr(jpar, "make_dqn_train_loop", jloop)
    monkeypatch.setattr(sys, "argv", ["train_evidence.py", "--game", game])
    with pytest.raises(_Built), redirect_stdout(io.StringIO()):
        jm.main()
    tvec, tloop = capture("port", TVec)
    monkeypatch.setattr(train_evidence, "VecGridWorld", tvec)
    monkeypatch.setattr(train_evidence, "make_dqn_train_loop", tloop)
    with pytest.raises(_Built):
        train_evidence.main(["--game", game, "--device", "cpu"])
    assert seen["port", "venv"] == seen["jax", "venv"]
    assert seen["port", "venv"][1] == 16
    assert seen["port", "loop"] == seen["jax", "loop"]
    assert seen["jax", "loop"]["steps_per_call"] == 10
