"""The program spans' readers (``program_spans.py`` and the metrics that
read it) on a hand-written Chrome trace: device operations, their
launches' correlations, and ``cpu_op`` spans of the program nested as the
port nests them; and the tiny env cell's own trace on the CPU, read by
``trace.Trace``."""

import json

import pytest
import torch

from h100bench import loops, program_spans, run, trace
from h100bench.tests import tiny

TRAIN_METRICS = ("rollout.device_ms_per_step.train",
                 "learn.device_ms_per_step.train",
                 "act.device_ms_per_step.train",
                 "rng.launches_per_step.train", "rng.gap_share.train",
                 "observe.device_ms_per_step.train",
                 "engine.device_ms_per_step.train")
ENV_METRICS = ("render.device_ms_per_step.env",
               "minimap.device_ms_per_step.env",
               "window.device_ms_per_step.env",
               "features.device_ms_per_step.env")

# (name, start, end) of the program's spans on the host, us
SPANS = [("train.rollout", 10, 400), ("env.observe", 15, 140),
         ("observe.grids", 16, 40), ("observe.render", 41, 70),
         ("observe.minimap", 71, 100), ("observe.window", 101, 120),
         ("observe.features", 121, 139), ("rng.randint", 150, 200),
         ("rng.split", 152, 170), ("rng.bits", 171, 199),
         ("net.act", 210, 300), ("env.transition", 310, 390),
         ("train.learn", 450, 900), ("rng.fold_in", 460, 480)]
# (launch ts on the host, device start, device end), us; one per operation
LAUNCHES = [(20, 500, 520),   # observe.grids
            (50, 520, 560),   # observe.render
            (80, 600, 610),   # observe.minimap, after a 40 us gap
            (110, 610, 640),  # observe.window
            (130, 640, 645),  # observe.features
            (160, 685, 690),  # rng.split inside rng.randint, after 40
            (180, 690, 695),  # rng.bits inside rng.randint
            (250, 735, 835),  # net.act, after 40
            (350, 835, 850),  # env.transition
            (470, 870, 880),  # rng.fold_in in train.learn, after 20
            (950, 960, 990)]  # outside every span, after 80
OBSERVE = ["env.observe", "train.rollout"]
def _write(path, spans=SPANS, launches=LAUNCHES):
    ev = [dict(ph="X", cat="user_annotation", name="stretch", ts=0, dur=1000,
               pid=1, tid=1)]
    for name, a, b in spans:
        ev.append(dict(ph="X", cat="cpu_op", name=name, ts=a, dur=b - a,
                       pid=1, tid=1))
    for c, (ts, a, b) in enumerate(launches):
        ev.append(dict(ph="X", cat="cpu_op", name="aten::add", ts=ts - 1,
                       dur=3, pid=1, tid=1))
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                       ts=ts, dur=1, pid=1, tid=1, args=dict(correlation=c)))
        ev.append(dict(ph="X", cat="kernel", name="kernel_%d" % c, ts=a,
                       dur=b - a, pid=0, tid=7, args=dict(correlation=c)))
    with open(path, "w") as f:
        json.dump(dict(traceEvents=ev), f)
    return trace.Trace(str(path))


def _ctx(tr, steps=2):
    ctx = run.Context()
    ctx.trace, ctx.steps = tr, steps
    return ctx


def _read(name, ctx):
    return run.load_module("metrics", name).read(ctx)


def test_each_operation_belongs_to_the_spans_that_held_its_launch(tmp_path):
    sp = program_spans.Spans(_write(tmp_path / "t.json"))
    assert [sorted(c) for c in sp.chains] == [
        sorted(OBSERVE + ["observe.grids"]),
        sorted(OBSERVE + ["observe.render"]),
        sorted(OBSERVE + ["observe.minimap"]),
        sorted(OBSERVE + ["observe.window"]),
        sorted(OBSERVE + ["observe.features"]),
        ["rng.randint", "rng.split", "train.rollout"],
        ["rng.bits", "rng.randint", "train.rollout"],
        ["net.act", "train.rollout"],
        ["env.transition", "train.rollout"],
        ["rng.fold_in", "train.learn"],
        []]
    assert "aten::add" not in sp.names and "stretch" not in sp.names


@pytest.mark.parametrize("name, program", [
    ("train.rollout", True), ("rng.bits", True), ("observe.window", True),
    ("env.transition", True), ("aten::add", False), ("aten::_foreach.x",
                                                      False),
    ("stretch", False), ("cudaLaunchKernel", False)])
def test_what_counts_as_a_program_span(name, program):
    assert program_spans.is_span(name) is program


def test_nested_rng_spans_count_an_operation_once(tmp_path):
    ctx = _ctx(_write(tmp_path / "t.json"), steps=1)
    # three operations in rng spans, the first two each inside two of them
    assert _read("rng.launches_per_step.train", ctx) == 3
    sp = program_spans.of(ctx)
    assert sp.device_s(program_spans.layer("rng")) == pytest.approx(20e-6)
    assert sp.device_s(program_spans.named("rng.randint", "rng.split")) == \
        pytest.approx(10e-6)


def test_a_gap_goes_to_the_spans_of_the_next_launch(tmp_path):
    sp = program_spans.Spans(_write(tmp_path / "t.json"))
    assert sp.idle_s() == pytest.approx(220e-6)
    assert sp.idle_s(program_spans.layer("rng")) == pytest.approx(60e-6)
    assert sp.idle_s(program_spans.named("net.act")) == pytest.approx(40e-6)
    assert sp.idle_s(program_spans.named("observe.minimap")) == \
        pytest.approx(40e-6)
    # operations that follow the one before without a gap take none
    for n in ("observe.window", "observe.features", "env.transition"):
        assert sp.idle_s(program_spans.named(n)) == 0
    ctx = _ctx(sp.trace)
    assert _read("rng.gap_share.train", ctx) == pytest.approx(100 * 60 / 220)


def test_an_operation_outside_every_span_counts_for_none(tmp_path):
    ctx = _ctx(_write(tmp_path / "t.json"), steps=2)
    got = {m: _read(m, ctx) for m in TRAIN_METRICS + ENV_METRICS}
    assert got == pytest.approx({
        "rollout.device_ms_per_step.train": 0.230 / 2,
        "learn.device_ms_per_step.train": 0.010 / 2,
        "act.device_ms_per_step.train": 0.100 / 2,
        "rng.launches_per_step.train": 3 / 2,
        "rng.gap_share.train": 100 * 60 / 220,
        "observe.device_ms_per_step.train": 0.105 / 2,
        "engine.device_ms_per_step.train": 0.015 / 2,
        "render.device_ms_per_step.env": 0.060 / 2,
        "minimap.device_ms_per_step.env": 0.010 / 2,
        "window.device_ms_per_step.env": 0.030 / 2,
        "features.device_ms_per_step.env": 0.005 / 2})
    # the last operation's 30 us and its 80 us gap are in none of them
    sp = program_spans.of(ctx)
    assert sp.device_s(lambda n: True) == pytest.approx(240e-6)
    assert sum(1 for c in sp.chains if not c) == 1


@pytest.mark.parametrize("name", TRAIN_METRICS + ENV_METRICS)
def test_each_reader_gives_none_without_a_trace_or_spans(name, tmp_path):
    assert _read(name, run.Context()) is None
    assert _read(name, _ctx(_write(tmp_path / "t.json"), steps=0)) is None
    # a program without spans: its trace holds PyTorch's operators alone
    bare = _write(tmp_path / "bare.json", spans=[])
    assert _read(name, _ctx(bare)) is None


def test_the_spans_leave_the_benchmarks_ranges_as_they_were(tmp_path):
    tr = _write(tmp_path / "t.json")
    assert tr.ranges == []
    assert tr.device_s_by_range() == {None: pytest.approx(270e-6)}


def test_the_env_cells_trace_keeps_its_ranges_and_holds_the_spans(tmp_path):
    """The tiny env cell's step under the CPU profiler, with the loop's own
    ranges: ``Trace`` lists those ranges alone, and the program's spans
    are among its ops, each inside the range around its call."""
    wl, cfg, traffic, _, _ = tiny.entries("battle_dqn.env")
    loop = loops.EnvLoop(cfg, traffic, 2**31 + 7, torch.device("cpu"))
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("stretch"):
            loop.step(loops._ranges(True))
    path = tmp_path / "env.json"
    prof.export_chrome_trace(str(path))
    tr = trace.Trace(str(path))
    assert [r["name"] for r in tr.ranges] == ["observe", "rng", "engine"]
    sp = program_spans.Spans(tr)
    assert {"env.observe", "env.transition", "observe.grids",
            "observe.render", "observe.minimap", "observe.window",
            "observe.features", "rng.split", "rng.uniform"} <= sp.names
    held = {"observe": ("env.observe", "observe."), "rng": ("rng.",),
            "engine": ("env.transition",)}
    for r in tr.ranges:
        for s in sp.spans:
            if s["name"].startswith(held[r["name"]]) and \
                    r["ts"] <= s["ts"] <= r["ts"] + r["dur"]:
                assert s["ts"] + s["dur"] <= r["ts"] + r["dur"]
    # the step's own key split precedes the ranges; the env's spans do not
    for s in sp.spans:
        if s["name"].startswith(("observe.", "env.")):
            assert tr.range_of(s["ts"]) in ("observe", "engine"), s["name"]


def test_the_readers_are_in_the_benchmark_as_the_cells_report_them():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    end_to_end = {m["name"]: m for m in bench["end_to_end"]}
    for names, cell, rate in (
            (TRAIN_METRICS, "battle_dqn.train", "train_agent_steps_per_s"),
            (ENV_METRICS, "battle_dqn.env", "env_agent_steps_per_s")):
        for n in names:
            m = per_layer[n]
            assert m["workloads"][0] == cell and m["moves"] == rate
            assert set(m["workloads"]) <= set(end_to_end[rate]["workloads"])
            assert m["source"] == "device_trace" and m["better"] == "lower"
