"""The benchmark harness on the CPU: tiny cells end to end, what it finds
by name, its counts, the no-JAX check, and that its check catches the
faults and the lower-precision control."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100bench import check, flops, peaks, run

from .tiny import entries, last_line, run_tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_prints_a_well_formed_last_line(cell):
    result, out, err = run_tiny(cell)
    line = last_line(out)
    assert line == json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checked"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0
    limits = json.loads((ROOT / ("h100bench/limits/%s.json" % cell)).read_text())
    assert set(line["checked"]) == set(limits)
    tail = err.strip().splitlines()[-len(limits):]
    assert all(t.startswith("check ") and t.endswith(" ok") for t in tail)


def test_everything_is_found_by_name():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        wl, cfg, traffic, per_layer, e2e = run.cell_entries(w["name"])
        assert traffic["kind"] in ("random_policy", "dqn_train")
        assert (ROOT / ("h100bench/limits/%s.json" % w["name"])).exists()
        assert {m["name"] for m in e2e} >= {"setup_s"}
        assert per_layer
    for m in BENCH["per_layer"]:
        assert callable(run.load_module("metrics", m["name"]).read)
    names = [p.stem for p in (ROOT / "h100bench/rooflines").glob("*.py")
             if p.stem != "__init__"]
    assert len(names) == 5
    for name in names:
        assert callable(run.load_module("rooflines", name).work)


def test_roofline_counts_on_hand_worked_shapes():
    B, A = 2, 3
    ints = torch.zeros((B, A), dtype=torch.int32)
    f32 = torch.zeros((B, A))
    found = torch.tensor([[0, -1, 2], [-1, -1, 1]], dtype=torch.int32)
    occ = run.load_module("rooflines", "occupant").work(
        (ints, ints, f32), {}, (found, f32))
    assert occ == dict(bytes=5 * 24, int32=2 * 9 + 2 * 3, f32=3)
    rp = run.load_module("rooflines", "rank_prefix").work((ints, ints, f32), {}, f32)
    assert rp == dict(bytes=4 * 24, int32=36, f32=18)
    mr = run.load_module("rooflines", "move_resolve").work(
        (ints, ints), {}, (ints, ints, ints))
    assert mr == dict(bytes=5 * 24, int32=9 * 18)
    view = torch.zeros((2, 5, 3, 4), dtype=torch.bfloat16)
    pos, mask = torch.zeros((2, 5), dtype=torch.int32), torch.zeros((3, 4))
    wg = run.load_module("rooflines", "window_gather").work(
        (None, pos, mask), {}, view)
    assert wg == dict(bytes=120 * 2 + 40 + 48, f32=120)
    assert peaks.least_seconds(dict(bytes=3.35e12)) == pytest.approx(1.0)
    assert peaks.least_seconds(dict(int32=peaks.INT32_PER_S, bytes=1)) == pytest.approx(1.0)


def test_model_flops_of_the_battle_dqn():
    net = dict(conv_channels=32, conv_kernel=3, dense=256)
    per = flops.dqn_forward((13, 13, 7), 34, 21, net)
    assert per["conv1"] == 2 * 11 * 11 * 32 * 9 * 7
    assert per["conv2"] == 2 * 9 * 9 * 32 * 9 * 32
    assert per["dense_view"] == 2 * 9 * 9 * 32 * 256
    assert per["dense_emb"] == 2 * 34 * 256
    assert per["heads"] == 2 * 512 * 22
    assert per["total"] == 3347904
    f = per["total"]
    assert flops.dqn_learn(per, 10) == 10 * (5 * f - per["conv1"] - per["dense_emb"])


def test_no_jax_check_compares_top_level_names_whole():
    assert run.forbidden_modules({"magent_tpu_torch", "magent_tpu_torch.ops",
                                  "jaxtyping", "flax_x"}) == []
    assert run.forbidden_modules({"magent_tpu.ops", "jax.numpy", "jaxlib",
                                  "flax.linen", "torch"}) == [
        "flax", "jax", "jaxlib", "magent_tpu"]


def test_a_run_loads_nothing_of_jax():
    code = ("import sys, torch; from h100bench.tests.tiny import run_tiny; "
            "r = run_tiny('battle_dqn.env')[0]; "
            "from h100bench.run import forbidden_modules; "
            "print(r['correct'], forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.stdout.split()[-2:] == ["True", "[]"], out.stderr[-2000:]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import h100bench.check, h100bench.reference.dqn, "
            "h100bench.reference.gridworld, h100bench.reference.threefry, "
            "h100bench.world, h100bench.flops, h100bench.peaks; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'magent_tpu_torch', 'magent_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]
    for path in (ROOT / "h100bench/reference").rglob("*.py"):
        for line in path.read_text().splitlines():
            if line.lstrip().startswith(("import ", "from ")):
                assert "magent_tpu" not in line, (path, line)


def _break(monkeypatch, fault):
    """Plant ``fault`` in the program underneath the timed path."""
    from magent_tpu_torch.parallel import optim, train, vec_env

    if fault == "state_unchanged":
        def update(self, net, state):
            for p in net.parameters():
                p.grad = None
            state.count += 1
            return state
        monkeypatch.setattr(optim.ClipAdam, "update", update)
    elif fault == "half_batch":
        td = train._td_loss

        def half(q_t, next_v, rew, terminal, mask, gamma):
            k = q_t.shape[0] // 2
            return td(q_t[:k], next_v[:k], rew[:k], terminal[:k], mask[:k], gamma)
        monkeypatch.setattr(train, "_td_loss", half)
    elif fault == "action_altered":
        eg = train._egreedy

        def altered(q, gkey, eps, venv):
            return (eg(q, gkey, eps, venv) + 1) % q.shape[-1]
        monkeypatch.setattr(train, "_egreedy", altered)
    elif fault == "call_key_reused":
        loop = train._scan_q_loop

        def reused(*a, **k):
            inner, first = loop(*a, **k), []

            def call(nets, targets, opts, state, key, eps, step0):
                first.append(key)
                return inner(nets, targets, opts, state, first[0], eps, step0)
            call.train_step = inner.train_step
            return call
        monkeypatch.setattr(train, "_scan_q_loop", reused)
    elif fault == "state_not_carried":
        loop = train._scan_q_loop

        def stale(*a, **k):
            inner = loop(*a, **k)

            def call(nets, targets, opts, state, *rest):
                out = inner(nets, targets, opts, state, *rest)
                return out[:3] + (state,) + out[4:]
            call.train_step = inner.train_step
            return call
        monkeypatch.setattr(train, "_scan_q_loop", stale)
    elif fault == "env_state_unchanged":
        tr = vec_env.VecGridWorld.transition

        def frozen(self, state, actions):
            _, rewards, alive, done = tr(self, state, actions)
            return state, rewards, alive, done
        monkeypatch.setattr(vec_env.VecGridWorld, "transition", frozen)
    elif fault == "half_envs":
        tr = vec_env.VecGridWorld.transition

        def half(self, state, actions):
            nxt, rewards, alive, done = tr(self, state, actions)
            k = state.x.shape[0] // 2
            keep = {f: torch.cat([getattr(nxt, f)[:k], getattr(state, f)[k:]])
                    for f in ("x", "y", "hp")}
            return nxt.replace(**keep), rewards, alive, done
        monkeypatch.setattr(vec_env.VecGridWorld, "transition", half)
    elif fault == "reward_altered":
        tr = vec_env.VecGridWorld.transition

        def altered(self, state, actions):
            nxt, rewards, alive, done = tr(self, state, actions)
            return nxt, rewards + 0.01, alive, done
        monkeypatch.setattr(vec_env.VecGridWorld, "transition", altered)


@pytest.mark.parametrize("cell,fault", [
    ("battle_dqn.train", "state_unchanged"),
    ("battle_dqn.train", "half_batch"),
    ("battle_dqn.train", "action_altered"),
    ("battle_dqn.train", "call_key_reused"),
    ("battle_dqn.train", "state_not_carried"),
    ("battle_dqn.env", "env_state_unchanged"),
    ("battle_dqn.env", "half_envs"),
    ("battle_dqn.env", "reward_altered"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    _break(monkeypatch, fault)
    result, out, err = run_tiny(cell, seconds=0.5)
    assert last_line(out)["correct"] is False
    assert "FAILED" in err


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_is_not_correct(cell):
    """The reference in the precision below the configuration's, in the
    program's place, fails one of the cell's limits (the net in bf16, its
    control in float8)."""
    from h100bench.loops import KINDS

    wl, cfg, traffic, _, _ = entries(cell, net_dtype="bf16")
    if traffic["kind"] == "dqn_train":
        traffic["train_minibatch"] = 512
    loop = KINDS[traffic["kind"]](cfg, traffic, 11, torch.device("cpu"))
    loop.warm()
    if traffic["kind"] == "dqn_train":
        got = check.check_train(loop, cfg, traffic, 11, torch.device("cpu"),
                                ("control",))["control"]
    else:
        loop.plan_checks(20)
        for _ in range(20):
            loop.call()
        got = check.check_env(loop, cfg, 11, torch.device("cpu"), control=True)[0]
    limits = run.load_json("limits", cell + ".json")
    assert any(got[k] > limits[k] for k in limits), got


def test_the_reference_draws_as_the_program_does():
    """The reference's threefry (NumPy) and the program's (PyTorch) agree
    on keys, uniforms, integers and the attack priorities' finaliser."""
    import numpy as np

    from h100bench.reference import threefry as tf
    from magent_tpu_torch import random as rnd

    seed = 2**33 + 12345
    key = tf.seed_key(seed)
    pk = rnd.fold_in(rnd.PRNGKey(seed & 0xFFFFFFFF), seed >> 32)
    assert (key.astype(np.int64) == pk.numpy()).all()
    ks, pks = tf.split(key, 5), rnd.split(pk, 5)
    assert (ks.astype(np.int64) == pks.numpy()).all()
    assert (tf.fold_in(ks, 77).astype(np.int64) == rnd.fold_in(pks, 77).numpy()).all()
    assert (tf.uniform(ks, (3, 100)) == rnd.uniform(pks, (3, 100)).numpy()).all()
    for hi in (5, 9, 21, 100000):
        assert (tf.randint(ks, (3, 100), 0, hi)
                == rnd.randint(pks, (3, 100), 0, hi).numpy()).all()
    z = np.arange(1000, dtype=np.uint32) * np.uint32(2654435761)
    assert (tf.fmix32(z).astype(np.int64) == rnd.splitmix_finalize(
        torch.from_numpy(z.astype(np.int64))).numpy()).all()


def test_the_layout_of_train_battle():
    """train_battle.py's squares at map 200: 1600 a side, two cells
    apart, 3 cells either side of the middle column."""
    from h100bench import world

    battle = run.load_json("configs", "battle_dqn.json")["world"]
    wall, (left, right) = world.layout(battle)
    assert len(left) == len(right) == 1600 and wall.sum() == 4 * 199
    assert left[:, 0].max() + 3 < 100 <= right[:, 0].min() - 3
    assert (left[:, 1].min(), left[:, 1].max()) == (60, 138)
