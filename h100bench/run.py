"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<mix>.json``), whose ``kind`` picks the loop
(``kinds/<kind>.py``, :data:`h100bench.loops.KINDS`).  Set-up builds the
world and nets from the seed, loads the kernels from the checkout's build
directory and warms the cell's shapes; the window then runs the loop's
calls for ``--seconds`` and reads the device once at its end.  With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from the window (CUDA events,
host clock), what the loop counts before the profiled stretch (host
syncs) and the profiled stretch after it.  After the window the loop's
judge (:mod:`h100bench.check`, against the plain reference) decides
``correct``; each compared number and its limit (``limits/<cell>.json``)
are printed last on standard error and last in the result line.  This
module asks the loop for all that it reports (the rate's name, the
steps, the stretch, the judge) and never tests the kind's name.

Everything of one cell is a file found by name, so a world, a trainer or
a metric is added without an edit here: a configuration in ``configs/``,
its placement kind in ``layouts/``, a traffic mix in ``traffic/``, a loop
kind in ``kinds/``, the rules the reference lacks in ``reference/``, a
cell's limits in ``limits/``, a per-layer metric's reader in
``metrics/<metric>.py`` and a kernel entry point's work in
``rooflines/<entry point>.py``; then the entries of ``BENCHMARK.json``.

A run without a CUDA device, or with fewer than the cell's chips, fails.
Nothing of JAX or of the JAX package may be loaded when the window has
closed."""

from __future__ import annotations

import os
import sys
import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "magent_tpu")


def process_start():
    """The epoch second this process started (``/proc``), else the time
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        start = btime + ticks / os.sysconf("SC_CLK_TCK")
        return start if start <= T_IMPORT else T_IMPORT
    except (OSError, ValueError, StopIteration, IndexError):
        return T_IMPORT


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def load_json(*parts):
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_module(kind, name):
    """``h100bench/<kind>/<name>.py`` by file name (names may hold dots)."""
    path = HERE / kind / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100bench.%s.%s" % (kind, name.replace(".", "_")), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entries(workload):
    """(workload entry, configuration, traffic, per-layer metrics of the
    cell, end-to-end metrics of the cell) from ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit("no workload %r in BENCHMARK.json" % workload)
    cfg = load_json("configs", wl["config"] + ".json")
    traffic = load_json("traffic", wl["traffic"] + ".json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return (wl, cfg, traffic, [m for m in bench["per_layer"] if mine(m)],
            [m for m in bench["end_to_end"] if mine(m)])


def set_cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")


class Recorder:
    """Wraps the port's kernel entry points while the profiled stretch runs,
    keeping each call's operands and results for ``rooflines/``."""

    def __init__(self):
        import magent_tpu_torch.ops.attack_prefix as ap
        import magent_tpu_torch.ops.window_gather as wg

        self.modules = (ap, wg)
        self.names = sorted(p.stem for p in (HERE / "rooflines").glob("*.py")
                            if p.stem != "__init__")
        self.calls, self.saved = [], []

    def __enter__(self):
        for mod in self.modules:
            for name in self.names:
                fn = getattr(mod, name, None)
                if fn is None:
                    continue
                self.saved.append((mod, name, fn))

                def rec(*args, _fn=fn, _name=name, **kwargs):
                    out = _fn(*args, **kwargs)
                    self.calls.append((_name, args, kwargs, out))
                    return out

                setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def least_s(self):
        from .peaks import least_seconds

        total = 0.0
        for name, args, kwargs, out in self.calls:
            total += least_seconds(load_module("rooflines", name).work(args, kwargs, out))
        return total


class Context:
    """What the per-layer metrics' readers read."""

    trace = None
    steps = 0
    step_gaps_ms = None
    syncs_per_train_step = None
    least_s = None
    flops_per_train_step = None
    chips = 1
    step_bytes = None

    def __init__(self):
        self.window = {}


def run_window(loop, seconds, step_events=False):
    """The loop's calls for ``seconds`` -> {"seconds", "calls", ...},
    ending in one read of the device.  ``step_events`` records a CUDA event
    after each call (no sync) and keeps the gaps between them."""
    import torch

    events = []
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        loop.call()
        n += 1
        if step_events:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)
    loop.read_sink()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return dict(seconds=dt, calls=n, gaps_ms=gaps)


def count_syncs(loop):
    """Host syncs over one loop call (``set_sync_debug_mode``'s warnings)."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop.call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    loop.read_sink()
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def profile_stretch(loop, tmpdir):
    """Profile the loop's short steady stretch -> (Trace, steps,
    Recorder)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as tracelib

    rf = record_function
    torch.cuda.synchronize()
    with Recorder() as recorder, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with rf("stretch"):
            steps = loop.profile(rf)
            torch.cuda.synchronize()
    loop.read_sink()
    path = os.path.join(tmpdir, "h100bench_trace_%d.json" % os.getpid())
    prof.export_chrome_trace(path)
    try:
        tr = tracelib.Trace(path)
    finally:
        os.remove(path)
    return tr, steps, recorder


def device_info(torch, chips):
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated()))


def power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(args, device=None, out=sys.stdout, err=sys.stderr):
    """One run of cell ``args.workload`` -> the result dict (printed as the
    last line of ``out``), or None when the run cannot start.  ``device``
    None looks for the cell's card; the harness's own tests pass the
    CPU."""
    t_start = process_start()
    set_cache_dirs()
    entries = getattr(args, "entries", None) or cell_entries(args.workload)
    wl, cfg, traffic, per_layer, end_to_end = entries
    import torch

    chips = int(wl["chips"])
    if device is None:
        if not has_cards(chips, err):
            return None
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    limits = (getattr(args, "limits", None)
              or load_json("limits", args.workload + ".json"))
    from .loops import KINDS

    loop = KINDS[traffic["kind"]](cfg, traffic, args.seed, device)
    loop.warm()
    if on_card:
        torch.cuda.synchronize()
    loop.before_window(args.seconds, run_window)
    setup_s = time.time() - t_start

    ctx = Context()
    ctx.chips = chips
    window = run_window(loop, args.seconds, bool(args.trace) and on_card)
    loop.after_window()
    work = window["calls"] * loop.work_per_call()
    ctx.window = {"seconds": window["seconds"],
                  loop.window_steps: window["calls"] * loop.steps_per_call}
    for k, v in loop.context().items():
        setattr(ctx, k, v)
    metrics, breakdown, info = {}, None, {}
    rate = work / window["seconds"]
    if not args.trace:
        metrics[loop.rate] = dict(value=rate, unit="agent-steps/s")
        metrics["setup_s"] = dict(value=setup_s, unit="s")
    elif on_card:
        ctx.step_gaps_ms = window["gaps_ms"]
        for k, v in loop.traced_context(count_syncs).items():
            setattr(ctx, k, v)
        tmp = os.environ.get("TMPDIR") or str(ROOT / "build")
        tr, steps, recorder = profile_stretch(loop, tmp)
        ctx.trace, ctx.steps = tr, steps
        ctx.least_s = recorder.least_s()
        traced_rate = steps * loop.agents_per_profiled_step / tr.window_s
        print("h100bench: tracing overhead: %.6g agent-steps/s in the "
              "profiled stretch vs %.6g in the window (%s)"
              % (traced_rate, rate, power_limit()), file=err)
        for m in per_layer:
            v = load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        breakdown = dict(device_ops=tr.top_ops(), idle_gaps=tr.idle_gaps())
        info = dict(busy_s=tr.busy_s(), window_s=tr.window_s)
    dev = (device_info(torch, chips) if on_card else
           dict(platform="cpu", kind="cpu", count=chips, memory_peak_bytes=0))
    dev.update(info)
    loop.free()
    if on_card:
        torch.cuda.empty_cache()
    return judged(args, loop, cfg, traffic, device, limits, window, metrics,
                  dev, breakdown, out, err)


def judged(args, loop, cfg, traffic, device, limits, window, metrics, dev,
           breakdown, out, err):
    """The check, the no-JAX check and the result line."""
    got, n_checked = loop.judge(cfg, traffic, args.seed, device)
    checks = {k: dict(value=got[k], limit=limits[k]) for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        print("h100bench: modules of JAX or the JAX package are loaded: %s"
              % ", ".join(found), file=err)
        return None
    attempted = window["calls"] * loop.steps_per_call
    result = dict(correct=correct, attempted=attempted,
                  failed=0 if correct else attempted, metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = checks
    print("h100bench: %s seed %d: %d checked %s, %s" % (
        args.workload, args.seed, n_checked, loop.unit, power_limit()),
        file=err)
    for k, c in checks.items():
        print("check %s %.9g limit %.9g %s" % (
            k, c["value"], c["limit"], "ok" if c["value"] <= c["limit"] else "FAILED"),
            file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result


def has_cards(chips, err):
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print("h100bench: the cell needs %d CUDA device(s), found %d"
              % (chips, found), file=err)
    return found >= chips


def cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=[0, 1])
    return ap


def main(argv=None):
    args = cli().parse_args(argv)
    return 0 if run_cell(args) is not None else 1


if __name__ == "__main__":
    sys.exit(main())
