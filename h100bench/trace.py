"""Reading a ``torch.profiler`` trace (its Chrome trace JSON).

Device events are the kernels, copies and sets on the card; each carries
the correlation id of the host call that launched it.  The benchmark's own
``record_function`` ranges (``observe``, ``rng``, ``engine``,
``train_step``) and the whole stretch's range (``stretch``) come as user
annotations on the host's timeline."""

from __future__ import annotations

import bisect
import collections
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the port's hand-written kernels (magent_tpu_torch/csrc/*.cu)
PORT_KERNEL = re.compile(
    r"\b(occupant|occupant_rect|occupant_rect_seg|rank_prefix|rank_prefix_seg|"
    r"move_resolve|move_claims|rect_first_overlap|rect_first_overlap_seg|"
    r"window_gather|window_ladder|window_shared_tile)_kernel\b")


class Trace:
    def __init__(self, path, stretch="stretch"):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        xs = [e for e in events if e.get("ph") == "X"]
        self.device = sorted((e for e in xs if e.get("cat") in DEVICE_CATS),
                             key=lambda e: e["ts"])
        self.launch_ts = {e["args"]["correlation"]: e["ts"] for e in xs
                          if e.get("cat") in LAUNCH_CATS
                          and "correlation" in e.get("args", {})}
        ranges = [e for e in xs if e.get("cat") == "user_annotation"]
        whole = [e for e in ranges if e["name"] == stretch]
        if not whole:
            raise ValueError("the trace has no %r range" % stretch)
        self.t0 = whole[0]["ts"]
        self.t1 = whole[0]["ts"] + whole[0]["dur"]
        self.ranges = sorted((e for e in ranges if e["name"] != stretch),
                             key=lambda e: e["ts"])
        self.range_starts = [e["ts"] for e in self.ranges]
        ops = sorted((e for e in xs if e.get("cat") == "cpu_op"),
                     key=lambda e: e["ts"])
        self.ops = ops
        self.op_starts = [e["ts"] for e in ops]
        self.device = [e for e in self.device
                       if e["ts"] + e.get("dur", 0) > self.t0 and e["ts"] < self.t1]

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    def _clip(self, e):
        return max(e["ts"], self.t0), min(e["ts"] + e.get("dur", 0), self.t1)

    def busy_intervals(self):
        """The union of device activity in the stretch, as merged
        intervals (us)."""
        out = []
        for e in self.device:
            a, b = self._clip(e)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def range_of(self, ts):
        """The name of the benchmark's range that holds host time ``ts``."""
        i = bisect.bisect_right(self.range_starts, ts) - 1
        while i >= 0:
            r = self.ranges[i]
            if r["ts"] <= ts <= r["ts"] + r["dur"]:
                return r["name"]
            i -= 1
        return None

    def op_at(self, ts):
        """The last host op that started at or before ``ts`` and holds it."""
        end = bisect.bisect_right(self.op_starts, ts)
        for o in reversed(self.ops[max(end - 64, 0):end]):
            if ts <= o["ts"] + o["dur"]:
                return o["name"]
        return "host"

    def device_s_by_range(self):
        """Device seconds of the events launched inside each range."""
        out = collections.Counter()
        for e in self.device:
            ts = self.launch_ts.get(e.get("args", {}).get("correlation"))
            name = self.range_of(ts) if ts is not None else None
            out[name] += e.get("dur", 0) * 1e-6
        return out

    def device_s_matching(self, pattern):
        rx = re.compile(pattern)
        return sum(e.get("dur", 0) for e in self.device
                   if rx.search(e["name"])) * 1e-6

    def port_kernel_s(self):
        return sum(e.get("dur", 0) for e in self.device
                   if e.get("cat") == "kernel" and PORT_KERNEL.search(e["name"])) * 1e-6

    def top_ops(self, n=10):
        by = collections.Counter()
        for e in self.device:
            by[e["name"][:120]] += e.get("dur", 0) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n=10):
        """The device's idle time between activities, summed by what the
        host was doing when it launched the next activity: the benchmark's
        range and the host op."""
        by = collections.Counter()
        merged = self.busy_intervals()
        starts = {}
        for e in self.device:
            starts.setdefault(max(e["ts"], self.t0), e)
        for (a0, a1), (b0, b1) in zip(merged, merged[1:]):
            nxt = starts.get(b0)
            label = "host"
            if nxt is not None:
                ts = self.launch_ts.get(nxt.get("args", {}).get("correlation"))
                if ts is not None:
                    label = "%s/%s" % (self.range_of(ts), self.op_at(ts))
            by[label] += (b0 - a1) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]
