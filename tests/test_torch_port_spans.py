"""The port's program spans (``magent_tpu_torch.spans``) on the CPU: a tiny
battle (map 20, caps [6, 6], B=2) stepped and trained under
``torch.profiler`` (CPU activity only).  The exported Chrome trace holds the
spans as ``cpu_op`` events, nested where the work runs; the program adds no
``user_annotation`` event, so ``record_function`` ranges around its calls
hold the same work with or without spans; and a train step is bit for bit
the same with a profiler recording as without."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from magent_tpu_torch import random as rnd
from magent_tpu_torch.builtin.config import battle
from magent_tpu_torch.builtin.torch_model import (A2CNet, DQNNet, DRQNNet,
                                                  params_from_flax)
from magent_tpu_torch.parallel import (ClipAdam, VecGridWorld,
                                       init_drqn_hiddens, make_a2c_train_step,
                                       make_dqn_train_step,
                                       make_dqn_train_step_remat,
                                       make_drqn_train_step)

MAP, CAPS, B, T = 20, [6, 6], 2, 2
TRUSTY = ["data/models/trusty-battle-game-%s/tfdqn_0.npz" % s for s in "lr"]
TRAINERS = ("dqn", "dqn_remat", "a2c", "drqn")
OBSERVE_SPANS = ("observe.grids", "observe.render", "observe.minimap",
                 "observe.window", "observe.features")
ROLLOUT_SPANS = {"net.act", "env.observe", "env.transition", *OBSERVE_SPANS}
# (span, the spans or ranges that hold each of its events; none: any)
DQN_SPANS = [("train.rollout", ()), ("train.learn", ()),
             ("net.act", ("train.rollout",)),
             ("env.observe", ("train.rollout",)),
             ("env.transition", ("train.rollout",)),
             *((n, ("env.observe",)) for n in OBSERVE_SPANS),
             ("rng.split", ()),
             ("rng.fold_in", ("train.rollout", "train.learn")),
             ("rng.bits", ("rng.uniform", "rng.randint")),
             ("rng.uniform", ("train.rollout",)),
             ("rng.randint", ("train.rollout", "train.learn"))]
ENV_SPANS = [("env.observe", ("observe",)), ("env.transition", ("engine",)),
             ("observe.window", ("env.observe",)),
             ("observe.features", ("env.observe",)),
             ("rng.uniform", ("rng",))]
ENV_RANGES = {"stretch", "train_step", "observe", "rng", "engine"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # many small tensor ops: one intra-op thread keeps the test workers
    # from stalling each other's OpenMP barriers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _venv():
    return VecGridWorld(battle.get_config(MAP), CAPS, B, device="cpu")


def _trainer(kind):
    """A fresh tiny trainer of ``kind`` -> ``step()``, which runs one train
    step and returns every tensor it produced (nets, optimizer state, env
    state, metrics)."""
    venv = _venv()
    spec = venv.spec
    tx = ClipAdam(1e-4, 5.0)
    state = venv.reset(rnd.PRNGKey(1))
    key = rnd.PRNGKey(2)

    def nets(cls, **kw):
        return tuple(cls(spec.view_space(g), spec.feature_size(g), 21, **kw)
                     for g in range(2))

    if kind in ("dqn", "dqn_remat"):
        online, target = nets(DQNNet), nets(DQNNet)
        for g in range(2):
            flat = params_from_flax(dict(np.load(TRUSTY[g])))
            online[g].load_state_dict(flat)
            target[g].load_state_dict(flat)
    else:
        cls = A2CNet if kind == "a2c" else DRQNNet
        online = tuple(
            cls(spec.view_space(g), spec.feature_size(g), 21,
                generator=torch.Generator().manual_seed(g)) for g in range(2))
        target = tuple(
            cls(spec.view_space(g), spec.feature_size(g), 21,
                generator=torch.Generator().manual_seed(g)) for g in range(2))
    opts = tuple(tx.init(n) for n in online)
    if kind == "dqn":
        ts = make_dqn_train_step(venv, tx, rollout_len=T, train_minibatch=16)

        def step():
            return ts(online, target, opts, state, key, 0.3)
    elif kind == "dqn_remat":
        ts = make_dqn_train_step_remat(venv, tx, rollout_len=T,
                                       sample_steps=1)

        def step():
            return ts(online, target, opts, state, key, 0.3)
    elif kind == "a2c":
        ts = make_a2c_train_step(venv, tx, rollout_len=T)

        def step():
            return ts(online, opts, state, key)
    else:
        ts = make_drqn_train_step(venv, tx, rollout_len=T)
        hiddens = init_drqn_hiddens(venv, online)

        def step():
            return ts(online, target, opts, state, hiddens, key, 0.3)
    return step


def _tensors(x):
    """Every tensor in ``x`` (nets, optimizer states, env states, dicts,
    tuples), in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x.detach()]
    if isinstance(x, torch.nn.Module):
        return [v.detach() for v in x.state_dict().values()]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for k in x.__dataclass_fields__
                for t in _tensors(getattr(x, k))]
    if hasattr(x, "_fields"):
        return [t for v in x for t in _tensors(v)]
    return []


def _profiled(fn, path):
    """``fn()`` under the CPU profiler inside the benchmark's ``stretch``
    and ``train_step`` ranges -> (fn's result, the trace's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("stretch"):
            with record_function("train_step"):
                out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return out, events


def _program_spans(events):
    """The program's spans: dotted names without PyTorch's ``::``."""
    return [e for e in events if e.get("cat") == "cpu_op"
            and "." in e["name"] and "::" not in e["name"]]


def _inside(e, outers):
    """Whether ``e`` starts and ends inside one of ``outers``."""
    return any(o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
               for o in outers)


@pytest.mark.parametrize("kind", TRAINERS)
def test_train_step_spans_nest_where_the_work_runs(kind, tmp_path):
    _, events = _profiled(_trainer(kind), tmp_path / "t.json")
    found = _program_spans(events)
    names = {e["name"] for e in found}
    assert {"train.rollout", "train.learn"} | ROLLOUT_SPANS <= names
    assert {"rng.split", "rng.fold_in", "rng.bits"} <= names
    draw = "rng.gumbel" if kind == "a2c" else "rng.randint"
    assert draw in names
    by = {n: [e for e in found if e["name"] == n] for n in names}
    rollout, learn = by["train.rollout"], by["train.learn"]
    assert len(rollout) == len(learn) == 1
    for n in ("net.act", "env.transition"):
        assert all(_inside(e, rollout) for e in by[n]), n
    # the learners of the remat trainer and A2C observe too
    for n in OBSERVE_SPANS:
        assert any(_inside(e, rollout) for e in by[n]), n
        assert all(_inside(e, rollout + learn) for e in by[n]), n
    # the rollout's observe holds every part of the observation (the remat
    # learner renders its grids itself)
    for n in OBSERVE_SPANS:
        held = [e for e in by[n] if _inside(e, rollout)]
        assert all(_inside(e, by["env.observe"]) for e in held), n
    rng = [e for e in found if e["name"].startswith("rng.")]
    assert any(_inside(e, rollout) for e in rng)
    # the DQN learners draw their minibatch or sampled steps; A2C's and
    # DRQN's learn from the whole window
    assert any(_inside(e, learn) for e in rng) is kind.startswith("dqn")
    # a draw that calls another nests the callee's span in its own
    for e in by[draw]:
        assert any(_inside(b, [e]) for b in by["rng.bits"])
    # the program adds no user annotation: the benchmark's ranges alone
    assert ({e["name"] for e in events if e.get("cat") == "user_annotation"}
            == {"stretch", "train_step"})
    assert all(e.get("cat") == "cpu_op" for e in found)


def _env_step():
    venv = _venv()
    state = venv.reset(rnd.PRNGKey(3))
    key = rnd.PRNGKey(4)

    def step():
        with record_function("observe"):
            obs = venv.observe_all(state)
        with record_function("rng"):
            actions = venv.random_actions(key)
        with record_function("engine"):
            out = venv.transition(state, actions)
        return obs, actions, out

    return step


def test_env_step_spans_and_the_ranges_around_them(tmp_path):
    with torch.no_grad():
        _, events = _profiled(_env_step(), tmp_path / "e.json")
    found = _program_spans(events)
    names = {e["name"] for e in found}
    assert {"env.observe", "env.transition", "rng.uniform", "rng.bits",
            "rng.split", *OBSERVE_SPANS} <= names
    assert "train.rollout" not in names and "net.act" not in names
    obs = [e for e in found if e["name"] == "env.observe"]
    assert len(obs) == 1
    assert all(_inside(e, obs) for e in found
               if e["name"].startswith("observe."))
    # the ranges around the calls are the only user annotations, and each
    # holds the spans of its call: a span takes no work from a range
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    assert sorted(e["name"] for e in ranges) == sorted(ENV_RANGES)
    by = {e["name"]: e for e in ranges}
    for e in found:
        if e["name"].startswith(("observe.", "env.observe")):
            assert _inside(e, [by["observe"]]), e["name"]
        if e["name"] == "env.transition":
            assert _inside(e, [by["engine"]])


@pytest.fixture(scope="module")
def step_events(tmp_path_factory):
    """The events of one profiled DQN train step and one env step."""
    path = tmp_path_factory.mktemp("spans")
    _, dqn = _profiled(_trainer("dqn"), path / "dqn.json")
    with torch.no_grad():
        _, env = _profiled(_env_step(), path / "env.json")
    return dict(dqn=dqn, env=env)


@pytest.mark.parametrize("step, name, holders",
                         [("dqn", *c) for c in DQN_SPANS]
                         + [("env", *c) for c in ENV_SPANS])
def test_each_span_is_a_cpu_op_inside_its_holder(step_events, step, name,
                                                 holders):
    events = step_events[step]
    mine = [e for e in events if e["name"] == name]
    assert mine and all(e.get("cat") == "cpu_op" for e in mine)
    assert mine == [e for e in _program_spans(events) if e["name"] == name]
    if holders:
        outer = [e for e in events if e["name"] in holders]
        assert all(_inside(e, outer) for e in mine)


@pytest.mark.parametrize("kind", TRAINERS)
def test_a_profiler_changes_no_bit_of_a_train_step(kind, tmp_path):
    plain = _tensors(_trainer(kind)())
    traced, _ = _profiled(_trainer(kind), tmp_path / "t.json")
    traced = _tensors(traced)
    assert len(plain) == len(traced) > 0
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
