"""The ``drqn_train`` kind on the CPU: the tiny ``battle_drqn.train`` cell's
judge reads ``correct`` false for each fault planted in the program
underneath the timed path and for the lower-precision control, and the
DRQN's spans appear in a profiled train step."""

import json

import pytest
import torch

from h100bench import check_drqn, flops_drqn, program_spans, run, trace
from h100bench.loops import KINDS

from .tiny import entries

CELL = "battle_drqn.train"
LIMITS = run.load_json("limits", CELL + ".json")
CPU = torch.device("cpu")
SEED = 11


def tiny(net_dtype="f32"):
    """The tiny cell (:func:`tiny.entries`) at hp 2, so that agents die in
    the call after set-up's: the reset of their GRU states is then
    checked."""
    wl, cfg, traffic, _, _ = entries(CELL, net_dtype)
    cfg["world"]["agent_types"]["small"]["hp"] = 2.0
    return cfg, traffic


def judged(cfg, traffic, calls=3, seed=SEED):
    """Set-up, ``calls`` calls of the window, the call after it, and the
    judge -> the checked numbers."""
    loop = KINDS[traffic["kind"]](cfg, traffic, seed, CPU)
    loop.warm()
    for _ in range(calls):
        loop.call()
    loop.read_sink()
    loop.after_window()
    loop.free()
    return loop.judge(cfg, traffic, seed, CPU)[0]


def correct(got):
    return all(got[k] <= LIMITS[k] for k in LIMITS)


class _BrokenReset:
    """The trainer module's ``torch`` with its one ``where(keep, h, 0.0)``
    (the GRU states' reset after each env step) broken."""

    def __init__(self, fault):
        self.fault = fault

    def __getattr__(self, name):
        return getattr(torch, name)

    def where(self, cond, a, b):
        if not (isinstance(b, float) and a.dim() == 3):
            return torch.where(cond, a, b)
        if self.fault == "not_zeroed":
            return a
        return torch.where(cond, a, b).detach()  # "bptt_cut"


def _break(monkeypatch, fault):
    """Plant ``fault`` in the program underneath the timed path."""
    from magent_tpu_torch.parallel import train, vec_env

    if fault in ("not_zeroed", "bptt_cut"):
        monkeypatch.setattr(train, "torch", _BrokenReset(fault))
    elif fault == "reset_each_call":
        loop = train._scan_q_loop

        def fresh(*a, **k):
            inner = loop(*a, **k)

            def call(nets, targets, opts, state, hiddens, *rest):
                zeros = tuple(torch.zeros_like(h) for h in hiddens)
                return inner(nets, targets, opts, state, zeros, *rest)
            call.train_step = inner.train_step
            return call
        monkeypatch.setattr(train, "_scan_q_loop", fresh)
    elif fault == "target_from_zero":
        unroll = train.split_unroll

        def from_zero(net, views, features, h0, **kw):
            return unroll(net, views, features, torch.zeros_like(h0), **kw)
        monkeypatch.setattr(train, "split_unroll", from_zero)
    elif fault == "reward_altered":
        tr = vec_env.VecGridWorld.transition

        def altered(self, state, actions):
            nxt, rewards, alive, done = tr(self, state, actions)
            return nxt, rewards + 0.01, alive, done
        monkeypatch.setattr(vec_env.VecGridWorld, "transition", altered)
    elif fault == "half_envs":
        tr = vec_env.VecGridWorld.transition

        def half(self, state, actions):
            nxt, rewards, alive, done = tr(self, state, actions)
            k = state.x.shape[0] // 2
            keep = {f: torch.cat([getattr(nxt, f)[:k], getattr(state, f)[k:]])
                    for f in ("x", "y", "hp")}
            return nxt.replace(**keep), rewards, alive, done
        monkeypatch.setattr(vec_env.VecGridWorld, "transition", half)


def test_the_tiny_cell_is_correct_and_its_deaths_are_checked():
    cfg, traffic = tiny()
    got = judged(cfg, traffic)
    assert correct(got), got
    assert got["hidden_gap"] < 1e-5 and got["loss_gap"] < 1e-4


@pytest.mark.parametrize("fault", ["not_zeroed", "reset_each_call",
                                   "bptt_cut", "target_from_zero",
                                   "reward_altered", "half_envs"])
def test_a_planted_drqn_fault_is_not_correct(monkeypatch, fault):
    _break(monkeypatch, fault)
    cfg, traffic = tiny()
    got = judged(cfg, traffic)
    assert not correct(got), got


def test_the_lower_precision_control_is_not_correct():
    """The reference with its trunk and GRU in float8 in the program's
    place fails one of the cell's limits (the net in bf16)."""
    cfg, traffic = tiny("bf16")
    loop = KINDS[traffic["kind"]](cfg, traffic, SEED, CPU)
    loop.warm()
    got = check_drqn.check_drqn(loop, cfg, traffic, SEED, CPU,
                                ("control",))["control"]
    assert any(got[k] > LIMITS[k] for k in LIMITS), got


def test_the_drqn_spans_are_in_a_profiled_train_step(tmp_path):
    """One train step under the CPU profiler: ``net.gru`` opens in the
    acting steps and the target re-unroll's carry steps (and again in the
    backward's recompute), ``net.unroll`` around the re-unroll, inside
    ``train.learn``; the readers find both."""
    cfg, traffic = tiny()
    loop = KINDS[traffic["kind"]](cfg, traffic, SEED, CPU)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("stretch"):
            steps = loop.profile(torch.profiler.record_function)
    path = tmp_path / "drqn.json"
    prof.export_chrome_trace(str(path))
    tr = trace.Trace(str(path))
    sp = program_spans.Spans(tr)
    assert {"net.gru", "net.unroll", "net.act", "train.learn"} <= sp.names
    spans = {n: [s for s in sp.spans if s["name"] == n]
             for n in ("net.gru", "net.unroll", "train.learn", "net.act")}
    T, G = int(traffic["rollout"]), 2

    def inside(s, outers):
        return any(o["ts"] <= s["ts"] and s["ts"] + s["dur"] <= o["ts"] + o["dur"]
                   for o in outers)

    assert len(spans["net.unroll"]) == G
    assert all(inside(s, spans["train.learn"]) for s in spans["net.unroll"])
    in_unroll = [s for s in spans["net.gru"] if inside(s, spans["net.unroll"])]
    in_act = [s for s in spans["net.gru"] if inside(s, spans["net.act"])]
    assert len(in_unroll) == G * T and len(in_act) == G * T
    # the checkpoint recomputes each acting step in the backward
    assert len(spans["net.gru"]) >= 3 * G * T
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    assert steps == 1


def test_the_drqn_flops_on_the_battle_shapes():
    """3.79 MFLOP an agent step, 3.15 of it in the GRU's six 512-wide
    projections; a train step of 64 worlds of 2x1600 over 8 frames."""
    cfg = run.load_json("configs", "battle_drqn.json")
    per = flops_drqn.drqn_forward((13, 13, 7), 34, 21, cfg["net"])
    assert per["gru_in"] + per["gru_state"] == 6 * 2 * 512 * 512
    assert per["total"] == (2 * 1183 * 256 + 2 * 34 * 256 + 6 * 2 * 512 * 512
                            + 2 * 512 * 22)
    n = 64 * 1600
    step = flops_drqn.drqn_train_step(per, n, 8)
    f = per["total"]
    assert step == n * (16 * f + 7 * (2 * f - 2 * 1183 * 256 - 2 * 34 * 256)
                        - 3 * 2 * 512 * 512)
    assert 2 * step == pytest.approx(22.08e12, rel=0.001)
