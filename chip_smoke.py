#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU.

Run from the repository root:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from ``magent_tpu_torch/csrc`` (nvcc, sm_90a);
2. runs one battle 2x1000, B=16 step with the kernel wrappers recording
   their operands, then holds each kernel against its plain PyTorch version
   on those operands (ints exact, floats within the stated atol) and times
   both with CUDA events;
3. runs the lockstep path — ``VecGridWorld(battle(200), [1000, 1000],
   n_envs=16)``: reset, warm-up, then timed ``observe_all -> random_actions
   -> transition`` steps — and checks from the launch counters that every
   step went through its four kernels; times each phase synchronized, then
   profiles a few more steps with torch.profiler (device ops and device
   time per step, busy share, the kernels that take the most time);
4. runs the stateful path — ``GridWorld("battle", map_size=125)`` with the
   2x625 armies ``examples/train_battle.py`` places: warm-up, then timed
   ``get_observation x2 -> set_action x2 -> step -> get_reward x2 ->
   clear_dead`` steps; checks from the launch counters that every step
   went through its kernels (``rank_prefix_hp``, ``move_claims`` once,
   ``window_gather`` twice), counts the host syncs per step and profiles a
   few steps; then holds the grid path's two kernels against their plain
   versions on the operands of one more step, and times them;
5. runs 4 steps at battle map 64, 2x200, B=4 and 6 GridWorld steps at
   battle map 40, 2x64, on the GPU and on the CPU from the same key and
   actions, and asserts equal states, views and features;
6. prints the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``
   as the last line.

Any failure raises (exit code 1).  Without a CUDA device it exits with 2
and prints no result.
"""

from __future__ import annotations

import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# battle's full width: the BASELINE.json headline workload (bench.py)
MAP_SIZE, N_PER_GROUP, N_ENVS = 200, 1000, 16
WARMUP_STEPS, TIMED_STEPS, PROFILE_STEPS = 3, 20, 5
# reduced size for the GPU-vs-CPU agreement run
SMALL_MAP, SMALL_N, SMALL_ENVS, SMALL_STEPS = 64, 200, 4, 4
# the stateful path: examples/train_battle.py's map, armies of 625 each
GW_MAP, GW_WARMUP, GW_TIMED, GW_SYNC_STEPS = 125, 10, 60, 5
# reduced size for the GridWorld GPU-vs-CPU run: 2x64 agents, map 40
GW_SMALL_MAP, GW_SMALL_STEPS = 40, 6

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# The data sheet's 67 TFLOP/s float32 counts an FMA as two operations; the
# kernels here do no FMA and mostly int32 work, so their peaks are taken per
# instruction, from the CUDA C++ Programming Guide's throughput table for
# compute capability 9.0: per SM and clock, 128 float32 adds or multiplies,
# 64 int32 adds, compares or min/max.  Times the SM count and the card's max
# SM clock (nvidia-smi clocks.max.sm): see peak_rates().
F32_PER_SM_CLK, INT32_PER_SM_CLK = 128, 64
# f32 tolerance of the pair sums: the kernel adds in slot order, the plain
# version in its reduction order (tests/test_pairwise_kernels.py:41)
PAIR_ATOL = 1e-5
# pooled minimap fractions may round differently between the CPU and GPU
# reductions; every other view value is a copy
VIEW_ATOL = 1e-6

# the fewest (int32, float32) instructions each pair kernel's formula needs
# per (query, slot) pair: a compare sets a predicate (a second compare ANDs
# into it), a select-and-add is one predicated add, a select-and-min one
# predicated min; shared-memory loads are not counted.
#   occupant      cell == q; cnt += m; ssum += i          | hsum += hp
#   rank_prefix   tgt == t; AND rank < r                  | p += dmg
#   move_resolve  i = i0 + k; same; AND i < j; cnt += ; head = min(head, i);
#                 cell == t; AND i != j; ocnt += ; osum += i
#   move_claims   i = i0 + k; same; AND i < j; cnt += ; head = min(head, i)
# rank_prefix_hp is rank_prefix's sweep; its hp_t is one load per query,
# charged as bytes (hp read, hp_t written).
PAIR_OPS = {"occupant": (3, 1), "rank_prefix": (2, 1), "move_resolve": (9, 0),
            "rank_prefix_hp": (2, 1), "move_claims": (5, 0)}
REPLACES = {
    "window_gather": "magent_tpu/ops/window_gather.py:167",
    "occupant": "magent_tpu/ops/attack_prefix.py:99 (occupant_tpu :285-322)",
    "rank_prefix": "magent_tpu/ops/attack_prefix.py:99 "
                   "(rank_prefix_tpu no-hp form :184-199)",
    "move_resolve": "magent_tpu/ops/attack_prefix.py:99 "
                    "(move_resolve_tpu :346-393)",
    "rank_prefix_hp": "magent_tpu/ops/attack_prefix.py:99 "
                      "(rank_prefix_tpu hp form :152-182)",
    "move_claims": "magent_tpu/ops/attack_prefix.py:99 "
                   "(move_claims_tpu :223-256)",
}
# the kernels' device symbols, as the profiler names them
SYMBOLS = {
    "window_gather": "window_gather_kernel", "occupant": "occupant_kernel",
    "rank_prefix": "rank_prefix_kernel<false>",
    "rank_prefix_hp": "rank_prefix_kernel<true>",
    "move_resolve": "move_resolve_kernel", "move_claims": "move_claims_kernel",
}
SOURCES = {
    "window_gather": "magent_tpu_torch/csrc/window_gather.cu",
    "occupant": "magent_tpu_torch/csrc/pair_kernels.cu",
    "rank_prefix": "magent_tpu_torch/csrc/pair_kernels.cu",
    "move_resolve": "magent_tpu_torch/csrc/pair_kernels.cu",
    "rank_prefix_hp": "magent_tpu_torch/csrc/pair_kernels.cu",
    "move_claims": "magent_tpu_torch/csrc/pair_kernels.cu",
}


def cuda_ms(fn, reps: int) -> float:
    """Time per call of ``fn`` in ms: CUDA events around ``reps``
    back-to-back calls (the host's launch work overlaps the device's, and
    bounds calls shorter than it), median of 3 such batches, after a
    warm-up.  Repeated calls find their inputs in the 50 MB L2, as the main
    path's kernels mostly do."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` in ms, without the host's launch work
    (which bounds back-to-back calls of a kernel shorter than it, see
    :func:`cuda_ms`): a spin kernel (``torch.cuda._sleep``) is queued ahead
    of the start event and outlasts the host's enqueueing of ``reps``
    calls, so CUDA events time the calls as the device runs them back to
    back, each after the device's own launch gap.  The spin doubles until
    it outlasts the enqueueing.  Median of 3 batches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    per_call = []
    while len(per_call) < 3:
        spun, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spun.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if spun.elapsed_time(start) <= enqueue_ms:
            if cycles >= 1 << 30:
                raise AssertionError("the host took %.3f ms to enqueue %d "
                                     "calls" % (enqueue_ms, reps))
            cycles *= 2
            continue
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def peak_rates():
    """(float32, int32) instructions per second of device 0 at its max SM
    clock; also returns the clock in MHz."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    sm_clk = torch.cuda.get_device_properties(0).multi_processor_count * \
        mhz * 1e6
    return F32_PER_SM_CLK * sm_clk, INT32_PER_SM_CLK * sm_clk, mhz


def window_gather_bytes(args, kwargs, out) -> int:
    """Bytes the window gather must move: every output written once, pos and
    mask read once, and each image element that some window reads under a
    non-zero mask entry read once.  The rest of the padded image (alignment
    slack, unused padding, cells no agent sees) is never needed."""
    gfull, pos, mask = args
    C, Wp = kwargs["C"], kwargs["Wp"]
    oy, ox = torch.nonzero(mask != 0, as_tuple=True)
    touched = torch.zeros(gfull.shape[1:], dtype=torch.bool,
                          device=gfull.device)
    n_read = 0
    for b in range(gfull.shape[0]):
        p = pos[b].long()
        touched.zero_()
        touched[(p // Wp)[:, None] + oy, (p % Wp)[:, None] * C + ox] = True
        n_read += int(touched.sum())
    return n_read * gfull.element_size() + nbytes([pos, mask]) + nbytes(out)


def record_operands(step_fn, wrappers):
    """Run ``step_fn`` with each ``(module, name)`` wrapper recording a copy
    of its operands; returns ``{name: (args, kwargs)}``."""
    captured = {}
    originals = {}
    for module, name in wrappers:
        fn = getattr(module, name)
        originals[(module, name)] = fn

        def rec(*args, _fn=fn, _name=name, **kwargs):
            captured[_name] = ([a.clone() for a in args], dict(kwargs))
            return _fn(*args, **kwargs)

        setattr(module, name, rec)
    try:
        step_fn()
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
    return captured


def assert_state_equal(a, b, tag):
    from magent_tpu_torch.core.state import FIELDS

    for name in FIELDS:
        x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError("%s: state field %s differs between GPU and "
                                 "CPU" % (tag, name))


def kernel_row(name, args, kwargs, f32_rate, int32_rate):
    """Hold kernel ``name`` against its plain version on recorded operands
    (ints and window copies exact, pair sums within PAIR_ATOL), time both,
    and compute its bound: instructions at ``f32_rate`` / ``int32_rate``
    per second against bytes at HBM_BYTES_PER_S."""
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.ops import window_gather as wg

    kernel, plain = {
        "window_gather": (wg.window_gather, wg.window_gather_ref),
        "occupant": (ap.occupant, ap.occupant_ref),
        "rank_prefix": (ap.rank_prefix, ap.rank_prefix_ref),
        "rank_prefix_hp": (ap.rank_prefix, ap.rank_prefix_ref),
        "move_resolve": (ap.move_resolve, ap.move_resolve_ref),
        "move_claims": (ap.move_claims, ap.move_claims_ref),
    }[name]
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want):
        raise AssertionError("%s: %d results vs plain %d" % (
            name, len(got), len(want)))
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError("%s: %s %s vs plain %s %s" % (
                name, tuple(g.shape), g.dtype, tuple(w.shape), w.dtype))
        if g.dtype.is_floating_point:
            e = float((g - w).abs().max()) if g.numel() else 0.0
            # window copies and the hp form's hp_t (a one-hot sum) are exact
            exact = name == "window_gather" or (name == "rank_prefix_hp"
                                                and k == 1)
            tol = 0.0 if exact else PAIR_ATOL
            if not e <= tol:
                raise AssertionError("%s: max |kernel - plain| = %g > %g"
                                     % (name, e, tol))
            err = max(err, e)
        elif not torch.equal(g, w):
            raise AssertionError("%s: integer outputs differ from the "
                                 "plain version" % name)
    from magent_tpu_torch import ops

    before = ops.launch_counts()[name]
    kernel(*args, **kwargs)
    if ops.launch_counts()[name] != before + 1:
        raise AssertionError("%s: a call did not launch its kernel once"
                             % name)
    ms = device_ms(lambda: kernel(*args, **kwargs), 50)
    plain_ms = device_ms(lambda: plain(*args, **kwargs), 5)
    call_ms = cuda_ms(lambda: kernel(*args, **kwargs), 50)
    if name == "window_gather":
        io_bytes = window_gather_bytes(args, kwargs, got)
        ops_ms = got[0].numel() / f32_rate * 1e3  # one multiply each
    else:
        io_bytes = nbytes(args) + nbytes(got)
        B, A = args[0].shape
        n_int, n_f32 = PAIR_OPS[name]
        ops_ms = B * A * A * max(n_int / int32_rate,
                                 n_f32 / f32_rate) * 1e3
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    row = dict(
        name=name, route="cuda", source=SOURCES[name],
        replaces=REPLACES[name], launches=None, max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None,
    )
    print("kernel %-14s max_abs_err=%g  kernel %.4f ms device (%.4f ms a "
          "call back to back)  plain %.4f ms device  bound %.6f ms (%s; "
          "%.4f MB -> %.6f ms, ops -> %.6f ms)  shapes %s" % (
              name, err, ms, call_ms, plain_ms, row["bound_ms"],
              row["bound_by"], io_bytes / 1e6, bytes_ms, ops_ms,
              [tuple(a.shape) for a in args]),
          flush=True)
    return row


def check_kernels(venv, state, key, f32_rate, int32_rate):
    """Phase 2: each lockstep-path kernel against its plain version on the
    operands the main path gave it."""
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.ops import window_gather as wg

    def one_step():
        venv.observe_all(state)
        venv.transition(state, venv.random_actions(key))

    ops = record_operands(one_step, [
        (wg, "window_gather"), (ap, "occupant"), (ap, "rank_prefix"),
        (ap, "move_resolve")])
    rows = {}
    for name in ("window_gather", "occupant", "rank_prefix", "move_resolve"):
        rows[name] = kernel_row(name, *ops[name], f32_rate, int32_rate)
    del ops
    torch.cuda.empty_cache()
    return rows


def run_main_path(venv, state, key, device_name):
    """Phase 3: the timed lockstep loop; returns (state, launch counts)."""
    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd

    def loop(state, key, n):
        sink = torch.zeros((), device=venv.device)
        for _ in range(n):
            keys = rnd.split(key)
            key, akey = keys[0], keys[1]
            for view, feat in venv.observe_all(state):
                sink = sink + view[:, :, 0, 0, 0].sum() + feat[:, 0, 0].sum()
            actions = venv.random_actions(akey)
            state, rewards, alive, done = venv.transition(state, actions)
            sink = sink + rewards[:, 0].sum()
        return state, key, sink

    state, key, sink = loop(state, key, WARMUP_STEPS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, key, sink = loop(state, key, TIMED_STEPS)
    float(sink)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    agent_steps = venv.spec.n_agents_cap * venv.n_envs * TIMED_STEPS
    print("main path: battle %dx%d, B=%d, %d timed steps in %.4f s: "
          "%.1f agent-steps/s, %.3f ms/step on %s" % (
              N_PER_GROUP, N_PER_GROUP, N_ENVS, TIMED_STEPS, dt,
              agent_steps / dt, dt / TIMED_STEPS * 1e3, device_name),
          flush=True)
    if not np.isfinite(float(sink)):
        raise AssertionError("main path produced non-finite values")
    expected = {"window_gather": 2 * TIMED_STEPS, "occupant": TIMED_STEPS,
                "rank_prefix": TIMED_STEPS, "move_resolve": TIMED_STEPS,
                "rank_prefix_hp": 0, "move_claims": 0}
    if counts != expected:
        raise AssertionError("launch counts %s, expected %s" % (counts,
                                                                 expected))

    carry = [state, key]

    def one_step():
        keys = rnd.split(carry[1])
        carry[1], akey = keys[0], keys[1]
        venv.observe_all(carry[0])
        carry[0] = venv.transition(carry[0], venv.random_actions(akey))[0]

    syncs, sites = count_host_syncs(one_step, PROFILE_STEPS)
    print("main path: %.1f host syncs per step (torch.cuda sync debug mode, "
          "%d steps); per step by call site: %s" % (
              syncs, PROFILE_STEPS, json.dumps(
                  {k: v / PROFILE_STEPS for k, v in sites.most_common()})),
          flush=True)
    state, key = carry

    # per-phase wall time (host clock around synchronized phases)
    phase = {"observe_all": [], "random_actions": [], "transition": []}
    for _ in range(5):
        keys = rnd.split(key)
        key, akey = keys[0], keys[1]
        t = time.perf_counter()
        obs = venv.observe_all(state)
        torch.cuda.synchronize()
        phase["observe_all"].append(time.perf_counter() - t)
        t = time.perf_counter()
        actions = venv.random_actions(akey)
        torch.cuda.synchronize()
        phase["random_actions"].append(time.perf_counter() - t)
        t = time.perf_counter()
        state, _, _, _ = venv.transition(state, actions)
        torch.cuda.synchronize()
        phase["transition"].append(time.perf_counter() - t)
    print("phases (median of 5 synchronized steps, ms): %s" % json.dumps(
        {k: statistics.median(v) * 1e3 for k, v in phase.items()}),
        flush=True)
    for g, (view, feat) in enumerate(obs):
        cap = venv.spec.groups[g].cap
        if tuple(view.shape) != (N_ENVS, cap) + venv.view_spaces()[g] or \
                tuple(feat.shape) != (N_ENVS, cap) + venv.feature_spaces()[g]:
            raise AssertionError("group %d observation shapes %s %s" % (
                g, tuple(view.shape), tuple(feat.shape)))
        if not (bool(torch.isfinite(view).all())
                and bool(torch.isfinite(feat).all())):
            raise AssertionError("group %d observations not finite" % g)

    # no two live agents share a cell
    W = venv.spec.width
    alive = state.active & ~state.dead
    cell = torch.where(alive, state.y * W + state.x, -1 - torch.arange(
        alive.shape[1], device=alive.device, dtype=torch.int32))
    srt = torch.sort(cell, dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        raise AssertionError("two live agents share a cell")
    return counts, state, key, dt / TIMED_STEPS * 1e3


def profile_steps(label, step, n_steps, ms_per_step):
    """torch.profiler over ``n_steps`` more calls of ``step()``: device ops
    per step, device time per step, and the device's busy share (measured
    with the profiler on, and estimated against the unprofiled
    ``ms_per_step``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): host ops carry
        # their kernels' time too and would count it twice
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((e.self_device_time_total / 1e3, e.count, e.key))
    if not kernels:
        print("%s profiler: no device events captured; device time not "
              "measured" % label, flush=True)
        return
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels) / n_steps
    own = {name: sum(k[0] for k in kernels if sym in k[2]) / n_steps
           for name, sym in SYMBOLS.items()}
    own_ms = sum(own.values())
    print("%s profiler: the hand-written kernels take %.4f ms/step of device "
          "time, %.4f of the device time and %.4f of the unprofiled step "
          "(%s)" % (label, own_ms, own_ms / device_ms if device_ms else 0.0,
                    own_ms / ms_per_step, json.dumps(
                        {k: v for k, v in own.items() if v})), flush=True)
    print("%s profiler, %d steps: %.1f device ops/step, %.4f ms device "
          "time/step in %.4f ms wall/step (busy share %.4f with the profiler "
          "on; estimated %.4f against the unprofiled %.4f ms/step); peak "
          "device memory %.3f GB" % (
              label, n_steps, sum(k[1] for k in kernels) / n_steps,
              device_ms, wall_ms / n_steps, device_ms * n_steps / wall_ms,
              device_ms / ms_per_step, ms_per_step,
              torch.cuda.max_memory_allocated() / 1e9),
          flush=True)
    for dev_ms, calls, name in kernels[:15]:
        print("  %9.4f ms/step  %6.1f calls/step  %s" % (
            dev_ms / n_steps, calls / n_steps, name[:90]))


def profile_main_path(venv, state, key, ms_per_step):
    """Phase 3b: the profiler over PROFILE_STEPS more lockstep steps."""
    from magent_tpu_torch import random as rnd

    carry = [state, key]

    def step():
        keys = rnd.split(carry[1])
        carry[1], akey = keys[0], keys[1]
        venv.observe_all(carry[0])
        carry[0] = venv.transition(carry[0], venv.random_actions(akey))[0]

    profile_steps("lockstep", step, PROFILE_STEPS, ms_per_step)


def check_gpu_matches_cpu():
    """Phase 5: the port on the GPU and on the CPU from the same key."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.parallel import VecGridWorld

    cfg = battle.get_config(SMALL_MAP)
    envs = {d: VecGridWorld(cfg, [SMALL_N, SMALL_N], SMALL_ENVS, device=d)
            for d in ("cuda", "cpu")}
    states = {d: envs[d].reset(rnd.PRNGKey(5)) for d in envs}
    assert_state_equal(states["cuda"], states["cpu"], "reset")
    key = rnd.PRNGKey(6)
    for step in range(SMALL_STEPS):
        keys = rnd.split(key)
        key, akey = keys[0], keys[1]
        obs = {d: envs[d].observe_all(states[d]) for d in envs}
        for (gv, gf), (cv, cf) in zip(obs["cuda"], obs["cpu"]):
            torch.testing.assert_close(gv.cpu(), cv, atol=VIEW_ATOL, rtol=0)
            torch.testing.assert_close(gf.cpu(), cf, atol=0, rtol=0)
        acts = {d: envs[d].random_actions(akey) for d in envs}
        if not torch.equal(acts["cuda"].cpu(), acts["cpu"]):
            raise AssertionError("random actions differ at step %d" % step)
        out = {d: envs[d].transition(states[d], acts[d]) for d in envs}
        states = {d: out[d][0] for d in envs}
        assert_state_equal(states["cuda"], states["cpu"], "step %d" % step)
        for a, b in zip(out["cuda"][1:], out["cpu"][1:]):
            if not torch.equal(a.cpu(), b):
                raise AssertionError("transition outputs differ at step %d"
                                     % step)
    print("GPU vs CPU: battle map %d, %dx%d, B=%d, %d steps: states, views "
          "and features equal" % (SMALL_MAP, SMALL_N, SMALL_N, SMALL_ENVS,
                                  SMALL_STEPS), flush=True)


def place_armies(env, handles):
    """``examples/train_battle.py:25-42`` ``generate_map`` in its first
    round (flipped: the first army on the right): two squares of
    (map^2 * 0.04) agents at stride 2, 3 cells either side of the middle."""
    map_size = env.spec.width
    side_len = int(math.sqrt(int(map_size * map_size * 0.04))) * 2
    gap = 3
    y0 = (map_size - side_len) // 2

    def square(x0):
        return [[x, y, 0] for x in range(x0, x0 + side_len, 2)
                for y in range(y0, y0 + side_len, 2)]

    env.add_agents(handles[0], method="custom", pos=square(map_size // 2 + gap))
    env.add_agents(handles[1], method="custom",
                   pos=square(map_size // 2 - gap - side_len))


def place_interleaved(env, handles):
    """The armies of :func:`place_armies` (2 x 625 at map 125, 2 x 64 at
    map 40) as one square, the second army one column right of the first:
    every agent has enemies in reach."""
    map_size = env.spec.width
    side_len = int(math.sqrt(int(map_size * map_size * 0.04))) * 2
    x0 = y0 = (map_size - side_len) // 2
    for k, h in enumerate(handles):
        env.add_agents(h, method="custom", pos=[
            [x + k, y, 0] for x in range(x0, x0 + side_len, 2)
            for y in range(y0, y0 + side_len, 2)])


def gridworld_step(env, handles, rng, place=place_armies):
    """One step of the stateful loop with uniform random actions; re-places
    the armies when the episode ends.  -> (live agents stepped, last group's
    (view, feature), rewards per group)."""
    live = 0
    for h in handles:
        view, feat = env.get_observation(h)
        live += len(view)
        env.set_action(h, rng.randint(0, env.get_action_space(h)[0],
                                      len(view)).astype(np.int32))
    done = env.step()
    rewards = [env.get_reward(h) for h in handles]
    env.clear_dead()
    if done:
        env.reset()
        place(env, handles)
    return live, (view, feat), rewards


def count_host_syncs(step, n_steps):
    """Synchronizing CUDA calls per ``step()``, counted by PyTorch's sync
    debug mode (one warning per call that waits for the device)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(n_steps):
                step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(
        "%s:%d" % (os.path.relpath(w.filename), w.lineno) for w in caught
        if "synchroniz" in str(w.message))
    return sum(sites.values()) / n_steps, sites


def run_gridworld_path(f32_rate, int32_rate, device_name):
    """Phase 4: the stateful GridWorld at train_battle's full width; returns
    the launch counts of the timed run and the grid path's kernel rows."""
    from magent_tpu_torch import GridWorld, ops
    from magent_tpu_torch.ops import attack_prefix as ap

    env = GridWorld("battle", map_size=GW_MAP)
    handles = env.get_handles()
    env.reset()
    place_armies(env, handles)
    rng = np.random.RandomState(0)
    n0 = [env.get_num(h) for h in handles]
    for _ in range(GW_WARMUP):
        gridworld_step(env, handles, rng)
    torch.cuda.synchronize()
    A = env.spec.n_agents_cap
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    live = 0
    for _ in range(GW_TIMED):
        n, (view, feat), rewards = gridworld_step(env, handles, rng)
        live += n
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    ms_per_step = dt / GW_TIMED * 1e3
    print("GridWorld path: battle map %d, %s agents placed, A=%d slots, %d "
          "timed steps in %.4f s: %.4f ms/step, %.1f agent-steps/s (%d live "
          "agent-steps) on %s" % (
              GW_MAP, n0, A, GW_TIMED, dt, ms_per_step, live / dt, live,
              device_name), flush=True)
    expected = {"window_gather": 2 * GW_TIMED, "rank_prefix_hp": GW_TIMED,
                "move_claims": GW_TIMED, "occupant": 0, "rank_prefix": 0,
                "move_resolve": 0}
    if counts != expected:
        raise AssertionError("GridWorld launch counts %s, expected %s" % (
            counts, expected))
    vs = env.get_view_space(handles[-1])
    fs = env.get_feature_space(handles[-1])
    if view.shape[1:] != vs or feat.shape[1:] != fs or \
            view.dtype != np.float32 or not (
            np.isfinite(view).all() and np.isfinite(feat).all()
            and all(np.isfinite(r).all() for r in rewards)):
        raise AssertionError("GridWorld outputs: shapes %s %s, want %s %s, "
                             "or not finite" % (view.shape, feat.shape, vs, fs))
    syncs, sites = count_host_syncs(
        lambda: gridworld_step(env, handles, rng), GW_SYNC_STEPS)
    print("GridWorld path: %.1f host syncs per step (torch.cuda sync debug "
          "mode, %d steps); per step by call site: %s" % (
              syncs, GW_SYNC_STEPS, json.dumps(
                  {k: v / GW_SYNC_STEPS for k, v in sites.most_common()})),
          flush=True)
    profile_steps("GridWorld", lambda: gridworld_step(env, handles, rng),
                  PROFILE_STEPS, ms_per_step)

    # the grid path's kernels against their plain versions at the same
    # widths (A=2048, B=1), on the operands of one step of the same armies
    # placed interleaved, so that every agent has enemies in reach and the
    # sweeps see shared targets and contested cells
    env.reset()
    place_interleaved(env, handles)
    rec = record_operands(lambda: gridworld_step(env, handles, rng),
                          [(ap, "rank_prefix"), (ap, "move_claims")])
    tgt, tcell = rec["rank_prefix"][0][0], rec["move_claims"][0][0]
    HW = env.spec.height * env.spec.width
    print("recorded step: %d attackers with a target, %d movers with a "
          "blank cell" % (int((tgt < A).sum()), int((tcell < HW).sum())),
          flush=True)
    rows = {"rank_prefix_hp": kernel_row("rank_prefix_hp",
                                         *rec["rank_prefix"], f32_rate,
                                         int32_rate),
            "move_claims": kernel_row("move_claims", *rec["move_claims"],
                                      f32_rate, int32_rate)}
    del rec, env
    torch.cuda.empty_cache()
    return counts, rows


def check_gridworld_gpu_matches_cpu():
    """Phase 5b: the stateful API on the GPU and on the CPU, same
    placements and actions, with clear_dead every step."""
    from magent_tpu_torch import GridWorld
    from magent_tpu_torch.core.state import FIELDS

    envs = {d: GridWorld("battle", map_size=GW_SMALL_MAP, device=d)
            for d in ("cuda", "cpu")}
    rngs = {d: np.random.RandomState(7) for d in envs}
    for d, env in envs.items():
        env.reset()
        # two interleaved 8x8 squares: attacks, kills and collisions at once
        place_interleaved(env, env.get_handles())
    spec = envs["cpu"].spec
    for step in range(GW_SMALL_STEPS):
        for g, h in enumerate(envs["cpu"].get_handles()):
            (gv, gf), (cv, cf) = (envs[d].get_observation(h) for d in envs)
            perm = spec.channel_perm(g)
            mm = sorted(int(perm[spec.group2channel(k)]) + 2
                        for k in range(spec.n_groups))
            rest = [c for c in range(gv.shape[-1]) if c not in mm]
            if gv.shape != cv.shape or not np.array_equal(
                    gv[..., rest], cv[..., rest]) or not np.array_equal(gf, cf) \
                    or not np.abs(gv[..., mm] - cv[..., mm]).max(
                        initial=0.0) <= VIEW_ATOL:
                raise AssertionError("GridWorld observations differ at step "
                                     "%d, group %d" % (step, g))
        outs = {}
        for d, env in envs.items():
            handles = env.get_handles()
            acts = []
            for h in handles:
                a = rngs[d].randint(0, env.get_action_space(h)[0],
                                    env.get_num(h)).astype(np.int32)
                env.set_action(h, a)
                acts.append(a)
            done = env.step()
            outs[d] = (done, [env.get_reward(h) for h in handles],
                       [env.get_pos(h) for h in handles],
                       [env.get_alive(h) for h in handles],
                       [env.get_agent_id(h) for h in handles], acts)
            env.clear_dead()
        if not all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(_flat(outs["cuda"]), _flat(outs["cpu"]))):
            raise AssertionError("GridWorld done/rewards/positions/alive/ids "
                                 "differ at step %d" % step)
        for name in FIELDS:
            x = getattr(envs["cuda"].state, name).cpu()
            if not torch.equal(x, getattr(envs["cpu"].state, name)):
                raise AssertionError("GridWorld state field %s differs at "
                                     "step %d" % (name, step))
    print("GridWorld GPU vs CPU: battle map %d, %s agents, %d steps with "
          "clear_dead: observations, rewards, positions, hp, alive, ids and "
          "done equal" % (GW_SMALL_MAP, [len(p) for p in outs["cpu"][2]],
                          GW_SMALL_STEPS), flush=True)


def _flat(items):
    for item in items:
        if isinstance(item, list):
            yield from _flat(item)
        else:
            yield item


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.ops import _build
    from magent_tpu_torch.parallel import VecGridWorld

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    log = _build.build(force=True)
    _build.lib()
    print("kernels built in %.1f s (nvcc, sm_90a)" % (time.perf_counter() - t0),
          flush=True)
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print("  ptxas:", line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    venv = VecGridWorld(battle.get_config(MAP_SIZE),
                        [N_PER_GROUP, N_PER_GROUP], n_envs=N_ENVS)
    state = venv.reset(rnd.PRNGKey(0))
    f32_rate, int32_rate, mhz = peak_rates()
    print("peak at %.0f MHz max SM clock: %.4g f32 and %.4g int32 "
          "instructions/s" % (mhz, f32_rate, int32_rate), flush=True)
    rows = check_kernels(venv, state, rnd.PRNGKey(1), f32_rate, int32_rate)
    counts, state, key, ms_per_step = run_main_path(
        venv, state, rnd.PRNGKey(2), device_name)
    for name, row in rows.items():
        row["launches"] = counts[name]
    profile_main_path(venv, state, key, ms_per_step)
    del venv, state
    torch.cuda.empty_cache()
    gw_counts, gw_rows = run_gridworld_path(f32_rate, int32_rate, device_name)
    for name, row in gw_rows.items():
        row["launches"] = gw_counts[name]
    rows.update(gw_rows)
    check_gpu_matches_cpu()
    check_gridworld_gpu_matches_cpu()

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
