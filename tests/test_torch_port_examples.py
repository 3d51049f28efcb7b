"""The port's training examples (``magent_tpu_torch/examples``) against the
JAX package's (``examples/``, loaded with ``importlib``), on the CPU.

- each example's config and map generator: the same compiled spec and the
  same placements (positions per group, walls) at the reference harness's
  sizes (``scripts/test/test_examples.py``);
- ``standard_cli`` and ``build_alg`` against the JAX ``rollout.py``;
- one round of each harness candidate with ``--train``, cut to ``STEPS``
  steps, on both backends: the JAX example's ``main`` runs with its
  ``EpisodeRunner`` cut (``max_steps``) and its round recorded, the port
  example through its ``setup`` with ``runner.max_steps`` cut the same way.
  train_arrange has no runner: both worlds end the round after ``STEPS``
  steps (the JAX one by a ``GridWorld`` whose ``step`` says done, the
  port's by ``play_a_round``'s ``max_steps``).  NumPy's global RNG is
  reseeded before each round (the rule bots, the episode buffers, the
  ``jax`` family's replay draws).  On the ``jax`` family the JAX models'
  initial parameters are carried to the port's (``set_params``); on the
  ``torch`` backend both packages draw them from the same seed, which is
  asserted.  Round 0's eps is 1, so every action is a draw on the same
  stream: per-group counts and reward totals are exact; what ``train``
  returns (losses, values) is within ``RTOL`` 1e-5 on the ``jax`` family
  (the trainers' tolerance: XLA's and PyTorch's convs and GEMMs round
  differently) and exact on the ``torch`` backend (both packages run the
  same PyTorch code on equal views);
- ``train_battle_fused`` (every algorithm) and ``api_demo`` run on the CPU
  at a tiny size (``tests/test_torch_port_fused_example.py`` holds
  ``train_battle_fused`` against the JAX example).
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

import magent_tpu as jmag

import magent_tpu_torch as tmag
from magent_tpu_torch.examples import rollout as trollout

from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_train_checks import flatten_tree

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
RTOL = 1e-5
STEPS = 6
SEED = 5
# the reference harness's candidates (scripts/test/test_examples.py:14-25)
CANDIDATES = {
    "train_battle": ["--train", "--n_round", "1", "--map_size", "32"],
    "train_single": ["--train", "--n_round", "1", "--map_size", "32"],
    "train_against": ["--train", "--n_round", "1", "--map_size", "32"],
    "train_multi": ["--train", "--n_round", "1", "--map_size", "32"],
    "train_pursuit": ["--train", "--n_round", "1", "--map_size", "64"],
    "train_tiger": ["--train", "--n_round", "1", "--map_size", "64"],
    "train_gather": ["--train", "--n_round", "1", "--map_size", "50"],
    "train_trans": ["--train", "--n_round", "1", "--map_size", "32"],
    "train_arrange": ["--train", "--n_round", "1", "--map_size", "48",
                      "--message", "HI"],
}


def jax_example(name):
    """A fresh module of the JAX example ``examples/<name>.py``."""
    if EXAMPLES not in sys.path:  # their ``from rollout import ...``
        sys.path.insert(0, EXAMPLES)
    spec = importlib.util.spec_from_file_location(
        "jax_example_" + name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name):
    return importlib.import_module("magent_tpu_torch.examples." + name)


# --------------------------------------------------------- specs and maps
def _assert_same_spec(t, j):
    skip = {"types", "groups", "reward_rules", "_compiled_rules"}
    assert set(vars(t)) == set(vars(j))
    for key in sorted(set(vars(j)) - skip):
        a, b = getattr(t, key), getattr(j, key)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert a == b, key
    for tg, jg in zip(t.groups, j.groups):
        assert (tg.group_id, tg.cap, tg.offset, tg.type.name) == (
            jg.group_id, jg.cap, jg.offset, jg.type.name)
    for g in range(j.n_groups):
        assert t.view_space(g) == j.view_space(g)
        assert t.feature_size(g) == j.feature_size(g)
        assert t.action_space(g) == j.action_space(g)
        np.testing.assert_array_equal(t.channel_perm(g), j.channel_perm(g))


def _worlds(name, map_size):
    """(JAX env, port env, place(env, module)) of example ``name``."""
    jm, tm = jax_example(name), port_example(name)
    if name in ("train_battle", "train_single", "train_against"):
        envs = (jmag.GridWorld("battle", map_size=map_size),
                tmag.GridWorld("battle", map_size=map_size, device="cpu"))
    elif name in ("train_multi", "train_gather"):
        envs = (jmag.GridWorld(jm.load_config(map_size)),
                tmag.GridWorld(tm.load_config(map_size), device="cpu"))
    elif name == "train_trans":
        envs = (jmag.GridWorld(jm.get_config(map_size)),
                tmag.GridWorld(tm.get_config(map_size), device="cpu"))
    elif name == "train_pursuit":
        envs = (jmag.GridWorld("pursuit", map_size=map_size),
                tmag.GridWorld("pursuit", map_size=map_size, device="cpu"))
    elif name == "train_tiger":
        envs = (jmag.GridWorld("double_attack", map_size=map_size),
                tmag.GridWorld("double_attack", map_size=map_size,
                               device="cpu"))
    else:
        from magent_tpu.renderer.server import arrange_server as jarr
        from magent_tpu.utility import FontProvider as JFont

        from magent_tpu_torch.renderer.server import arrange_server as tarr

        envs = (jmag.GridWorld(jarr.load_config(map_size)),
                tmag.GridWorld(tarr.load_config(map_size), device="cpu"))

    def place(env, mod):
        handles = env.get_handles()
        if name == "train_gather":
            mod.generate_map(env, map_size, *handles)
        elif name == "train_arrange":
            font = (JFont if mod is jm else tmag.utility.FontProvider)(
                os.path.join(REPO, "data", "font_8x8", "basic.txt"))
            gen = (jarr if mod is jm else tarr).generate_map
            gen(env, map_size, handles[0], handles[1], ["HI"], font)
        else:
            if hasattr(mod, "_flip"):
                mod._flip[0] = False
            mod.generate_map(env, map_size, handles)
    return envs, place, jm, tm


@pytest.mark.parametrize("name", sorted(CANDIDATES))
def test_config_and_map_match_jax(name):
    map_size = int(CANDIDATES[name][CANDIDATES[name].index("--map_size") + 1])
    (jenv, tenv), place, jm, tm = _worlds(name, map_size)
    _assert_same_spec(tenv.spec, jenv.spec)
    for _ in range(2):  # train_battle mirrors its armies every round
        jenv.reset()
        tenv.reset()
        place(jenv, jm)
        place(tenv, tm)
        np.testing.assert_array_equal(np.asarray(tenv._get_walls_info()),
                                      np.asarray(jenv._get_walls_info()))
        for jh, th in zip(jenv.get_handles(), tenv.get_handles()):
            assert tenv.get_num(th) == jenv.get_num(jh) > 0
            np.testing.assert_array_equal(tenv.get_pos(th), jenv.get_pos(jh))


# -------------------------------------------------- the shared round loop
@pytest.mark.parametrize("argv", [
    [], ["--train", "--n_round", "3", "--map_size", "40", "--alg", "a2c"],
    ["--load_from", "4", "--greedy", "--backend", "torch", "--eval",
     "--name", "x", "--render", "--render_every", "2", "--save_every", "7"],
])
@pytest.mark.parametrize("algs", [("dqn", "drqn", "a2c"), ("dqn", "drqn"),
                                  None])
def test_standard_cli_matches_jax(argv, algs):
    jro = jax_example("train_battle").standard_cli.__globals__
    if algs is None:
        argv = [a for a in argv if a not in ("--alg", "a2c")]
    if algs == ("dqn", "drqn"):
        argv = ["drqn" if a == "a2c" else a for a in argv]
    want = vars(jro["standard_cli"]("battle", n_round=10, map_size=64,
                                    save_every=3, algs=algs).parse_args(argv))
    got = vars(trollout.standard_cli("battle", n_round=10, map_size=64,
                                     save_every=3, algs=algs).parse_args(
        argv + ["--device", "cpu"]))
    assert got == dict(want, device="cpu")
    assert vars(trollout.standard_cli(
        "battle", n_round=1, map_size=2).parse_args([]))["device"] is None


@pytest.mark.parametrize("backend", ["jax", "torch"])
@pytest.mark.parametrize("alg", ["dqn", "drqn", "a2c"])
def test_build_alg_matches_jax(alg, backend):
    jro = jax_example("train_battle").build_alg.__globals__
    kw = dict(target_update=500, memory_size=3000)
    if alg == "drqn" and backend == "torch":
        with pytest.raises(ValueError) as want:
            jro["build_alg"](alg, backend=backend, **kw)
        with pytest.raises(ValueError) as got:
            trollout.build_alg(alg, backend=backend, **kw)
        assert str(got.value) == str(want.value)
        return
    for extra in ({}, kw):
        jcls, jkw = jro["build_alg"](alg, backend=backend, **extra)
        tcls, tkw = trollout.build_alg(alg, backend=backend, **extra)
        assert tkw == jkw
        assert tcls.__name__ == jcls.__name__
        family = {"jax": "torch_model", "torch": "th_model"}[backend]
        assert tcls.__module__.startswith(
            "magent_tpu_torch.builtin.%s." % family)
    assert trollout.model_module(backend) is importlib.import_module(
        "magent_tpu_torch.builtin." + family)


# ------------------------------------------------------- one cut round
def _snapshot(model):
    """A model's initial parameters, as the port loads them (None for the
    rule bots)."""
    model = getattr(model, "model", model)
    if hasattr(model, "params"):
        return ("flax", flatten_tree(jax.device_get(model.params)))
    if hasattr(model, "state_arrays"):  # (views of the live CPU tensors)
        return ("state", {k: np.array(v)
                          for k, v in model.state_arrays().items()})
    return None


def _models(sides):
    seen, out = set(), []
    for s in sides:
        if id(s.model) not in seen:
            seen.add(id(s.model))
            out.append(s.model)
    return out


def _recorded(runner, rec):
    """Wrap ``runner``'s sample and train to record their raw returns."""
    sample, train = runner.sample, runner.train

    def rec_sample(*a, **k):
        rec["totals"] = sample(*a, **k)
        return rec["totals"]

    def rec_train():
        rec["train"] = train()
        return rec["train"]

    runner.sample, runner.train = rec_sample, rec_train


def _jax_round(name, backend, monkeypatch):
    """The JAX example's ``main`` on the candidate's argv for one round cut
    to STEPS steps -> {"init", "out", "totals", "train"}."""
    jm = jax_example(name)
    rec = {}
    argv = CANDIDATES[name] + ["--backend", backend]
    monkeypatch.setattr(sys, "argv", [name] + argv)
    monkeypatch.setattr(jmag.utility, "init_logger", lambda _: None)
    if name == "train_arrange":
        class Cut(jmag.GridWorld):
            def step(self):
                self._cut_ct = getattr(self, "_cut_ct", 0) + 1
                return super().step() or self._cut_ct >= STEPS

        play = jm.play_a_round

        def cut_play(env, map_size, font, messages, handles, model, **kw):
            rec["init"] = [_snapshot(model)]
            train = model.train

            def rec_train(*a, **k):
                rec["train"] = train(*a, **k)
                return rec["train"]

            model.train = rec_train
            np.random.seed(SEED)
            rec["out"] = play(env, map_size, font, messages, handles, model,
                              **kw)
            return rec["out"]

        monkeypatch.setattr(jmag, "GridWorld", Cut)
        monkeypatch.setattr(jm, "play_a_round", cut_play)
    else:
        class CutRunner(jm.EpisodeRunner):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.max_steps = STEPS - 1
                _recorded(self, rec)

            def play(self, eps, **k):
                rec["init"] = [_snapshot(m) for m in _models(self.sides)]
                np.random.seed(SEED)
                rec["out"] = super().play(eps, **k)
                return rec["out"]

        monkeypatch.setattr(jm, "EpisodeRunner", CutRunner)
    jm.main()
    monkeypatch.undo()
    return rec


def _port_round(name, backend, init):
    """The port example's round through its ``setup``, cut the same way;
    ``init``: the JAX models' initial parameters."""
    tm = port_example(name)
    if hasattr(tm, "_flip"):  # as the fresh JAX module starts
        tm._flip[0] = False
    args = tm.cli().parse_args(CANDIDATES[name] + ["--backend", backend,
                                                   "--device", "cpu"])
    ex = tm.setup(args)
    models = [ex.model] if name == "train_arrange" else _models(
        ex.runner.sides)
    assert len(models) == len(init)
    for m, (kind, flat) in zip(models, [i or (None, None) for i in init]):
        m = getattr(m, "model", m)
        if kind == "flax":
            m.set_params(flat)
        elif kind == "state":  # the second backend: the same seeded draws
            got = m.state_arrays()
            assert sorted(got) == sorted(flat)
            for k, v in flat.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    rec = {}
    eps = tm.round_eps(args, 0)
    assert eps == 1
    if name == "train_arrange":
        train = ex.model.train

        def rec_train(*a, **k):
            rec["train"] = train(*a, **k)
            return rec["train"]

        ex.model.train = rec_train
        np.random.seed(SEED)
        rec["out"] = tm.play_a_round(
            ex.env, args.map_size, ex.font, [args.message], ex.handles,
            ex.model, train=args.train, render=False, eps=eps,
            max_steps=STEPS - 1)
        return rec
    ex.runner.max_steps = STEPS - 1
    _recorded(ex.runner, rec)
    ex.new_round()
    np.random.seed(SEED)
    rec["out"] = ex.runner.play(eps, train=args.train)
    return rec


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flat(item)]
    return [float(x)]


@pytest.mark.parametrize("backend", ["jax", "torch"])
@pytest.mark.parametrize("name", sorted(CANDIDATES))
def test_example_round_matches_jax(name, backend, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want = _jax_round(name, backend, monkeypatch)
    monkeypatch.chdir(tmp_path)
    got = _port_round(name, backend, want["init"])
    exact = backend == "torch"
    if name == "train_arrange":
        # (loss, reward, value, filled): the reward and the filled count
        # exact; what train returned as the trainers are held
        assert got["out"][1:4:2] == want["out"][1:4:2]
        pairs = [(got["train"], want["train"])]
    else:
        # (loss, nums, reward, value): counts and reward totals exact
        assert got["out"][1] == want["out"][1]
        np.testing.assert_array_equal(got["totals"], want["totals"])
        pairs = [(got["train"], want["train"])]
    for g, w in pairs:
        g, w = _flat(g), _flat(w)
        assert len(g) == len(w) and any(v != 0 for v in w)
        if exact:
            assert g == w
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


# ------------------------------------------------------ the fused example
@pytest.mark.parametrize("alg", ["dqn", "dqn_remat", "drqn", "a2c"])
def test_train_battle_fused_runs_on_the_cpu(alg, tmp_path, monkeypatch):
    """Two loop calls of one train step each at map 20, 2 x 6 agents, B=2,
    through ``main``; the checkpoints of both groups load into the hosted
    DQN (flax layout) where the algorithm is a DQN."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmag.utility, "init_logger", lambda _: None)
    fused = port_example("train_battle_fused")
    fused.main(["--alg", alg, "--device", "cpu", "--n_round", "2",
                "--steps_per_call", "1", "--map_size", "20",
                "--agents_per_side", "6", "--n_envs", "2", "--rollout_len",
                "3", "--train_minibatch", "32", "--dtype", "bf16"])
    sub = fused.SUBCLASS[alg]
    for tag in "lr":
        assert os.path.exists(os.path.join(
            "save_model", "battle-fused-" + tag, sub + "_0.npz"))
    args = fused.cli().parse_args(["--alg", alg, "--device", "cpu",
                                   "--map_size", "20", "--agents_per_side",
                                   "6", "--n_envs", "2", "--rollout_len", "3",
                                   "--train_minibatch", "32",
                                   "--steps_per_call", "1"])
    ex = fused.setup(args)
    metrics = ex.call(0, 1.0)
    assert metrics["loss"].shape == (1, 2)
    assert torch.isfinite(metrics["loss"]).all()
    if alg.startswith("dqn"):
        env = tmag.GridWorld("battle", map_size=20, device="cpu")
        m = tmag.builtin.torch_model.DeepQNetwork(
            env, env.get_handles()[0], "battle-fused-l", memory_size=8,
            device="cpu")
        m.load("save_model", 0)


def test_api_demo_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    api_demo = port_example("api_demo")
    np.random.seed(0)
    steps = api_demo.run(device="cpu", map_size=30, max_steps=5)
    assert steps == 6
    assert os.path.exists(os.path.join("build", "render", "config.json"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api_demo.main([])


def test_train_battle_game_main_logs_its_round(tmp_path, monkeypatch,
                                               caplog):
    """``train_battle_game.main`` (train_battle's loop under the trusty
    names) at map 16, one round cut to 3 steps, trained and saved: the
    round's log line and both groups' checkpoints."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmag.utility, "init_logger", lambda _: None)
    battle = port_example("train_battle")

    class Cut(battle.EpisodeRunner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.max_steps = 2

    monkeypatch.setattr(battle, "EpisodeRunner", Cut)
    with caplog.at_level("INFO"):
        port_example("train_battle_game").main(
            ["--train", "--n_round", "1", "--map_size", "16", "--save_every",
             "1", "--device", "cpu"])
    assert any(r.getMessage().startswith("round 0\t loss: [")
               for r in caplog.records)
    for tag in "lr":
        assert os.path.exists(os.path.join(
            "save_model", "trusty-battle-game-" + tag, "tfdqn_0.npz"))
