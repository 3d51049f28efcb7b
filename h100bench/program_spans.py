"""The program's own spans in a profiled stretch.

The program marks its phases with named ``cpu_op`` events
(``train.rollout``, ``observe.render``, ``rng.bits``, ...;
``magent_tpu_torch/spans.py``) on the profiler's clock.  Each device
operation of the stretch belongs to the chain of program spans whose
time holds its launch, on whichever host thread: the learner's
backward launches from autograd's thread while ``train.learn`` holds the
main one.  "Inside X" means inside any span named X of that chain, counted
once however deeply spans of that name nest (``rng.randint`` calls
``rng.split`` and ``rng.bits``).  An idle gap is one of
``Trace.idle_gaps``' gaps between merged device intervals, and belongs to
the chain of the operation that ends it.

A program span is a ``cpu_op`` event whose name holds a dot and no
``::`` (PyTorch's operators have ``::``); the readers match the names
they read.  A program without spans gives no chains: every reader here
returns None for it."""

from __future__ import annotations

import bisect


def is_span(name):
    """Whether a ``cpu_op`` event named ``name`` is one of the program's
    spans."""
    return "." in name and "::" not in name


class Spans:
    """The program spans of ``trace`` (:class:`h100bench.trace.Trace`) and
    the chain of span names of each of its device operations."""

    def __init__(self, trace):
        self.trace = trace
        self.spans = [o for o in trace.ops if is_span(o["name"])]
        self.names = {o["name"] for o in self.spans}
        launched = sorted(  # (launch ts, index into trace.device)
            (trace.launch_ts[c], i) for i, c in enumerate(
                e.get("args", {}).get("correlation") for e in trace.device)
            if c in trace.launch_ts)
        at = [ts for ts, _ in launched]
        self.chains = [set() for _ in trace.device]
        for s in self.spans:
            lo = bisect.bisect_left(at, s["ts"])
            hi = bisect.bisect_right(at, s["ts"] + s.get("dur", 0))
            for _, i in launched[lo:hi]:
                self.chains[i].add(s["name"])

    def has(self, match):
        """Whether any program span's name satisfies ``match``."""
        return any(match(n) for n in self.names)

    def device_s(self, match):
        """Device seconds of the operations launched inside a span whose
        name satisfies ``match``."""
        return sum(e.get("dur", 0)
                   for e, c in zip(self.trace.device, self.chains)
                   if any(match(n) for n in c)) * 1e-6

    def launches(self, match):
        """Device operations launched inside a span whose name satisfies
        ``match``."""
        return sum(1 for c in self.chains if any(match(n) for n in c))

    def idle_s(self, match=None):
        """Device idle seconds between the stretch's merged busy intervals
        (``Trace.idle_gaps``' gaps); with ``match``, only the gaps whose
        next operation was launched inside a span whose name satisfies
        it."""
        tr = self.trace
        merged = tr.busy_intervals()
        first = {}
        for i, e in enumerate(tr.device):
            first.setdefault(max(e["ts"], tr.t0), i)
        total = 0.0
        for (_, a1), (b0, _) in zip(merged, merged[1:]):
            if match is not None:
                i = first.get(b0)
                if i is None or not any(match(n) for n in self.chains[i]):
                    continue
            total += b0 - a1
        return total * 1e-6


def named(*names):
    """A ``match`` for spans named one of ``names``."""
    return lambda n: n in names


def layer(prefix):
    """A ``match`` for every span of layer ``prefix`` (``rng``: ``rng.*``)."""
    return lambda n: n.startswith(prefix + ".")


def of(ctx):
    """The context's :class:`Spans`, built once per trace; None without a
    trace or a step."""
    if ctx.trace is None or not ctx.steps:
        return None
    cached = getattr(ctx, "_program_spans", None)
    if cached is None or cached.trace is not ctx.trace:
        cached = Spans(ctx.trace)
        ctx._program_spans = cached
    return cached


def device_ms_per_step(ctx, match):
    """Device ms per profiled step of the operations launched inside a span
    ``match`` names; None where the trace holds no such span."""
    sp = of(ctx)
    if sp is None or not sp.has(match):
        return None
    return 1e3 * sp.device_s(match) / ctx.steps
