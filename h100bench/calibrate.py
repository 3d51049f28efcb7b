"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 -m h100bench.calibrate --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 3] [--seconds 2]

For each seed, in one process, the cell's set-up and a short window (for
``random_policy`` cells, the steps kept for the check; for ``dqn_train``
cells, the call after it recorded), then the numbers that decide
``correct`` (the loop's ``calibrate``, ``kinds/<kind>.py``): of the
program (``program``), of the reference computed in the precision below
the configuration's put in the program's place (``control``, on the
first ``--control-seeds`` seeds) and, for ``dqn_train`` cells, of the
reference with half of its minibatch left out (``fault_half_batch``).
One JSON line per seed; the benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .loops import KINDS
from .run import cell_entries, has_cards, run_window, set_cache_dirs


def readings(workload, seed, seconds, control, device):
    wl, cfg, traffic, _, _ = cell_entries(workload)
    loop = KINDS[traffic["kind"]](cfg, traffic, seed, device)
    loop.warm()
    loop.before_window(seconds, run_window)
    run_window(loop, seconds)
    loop.after_window()
    loop.free()
    out = dict(seed=seed)
    out.update(loop.calibrate(cfg, traffic, seed, device, control))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    if not has_cards(int(cell_entries(args.workload)[0]["chips"]), sys.stderr):
        return 1
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        r = readings(args.workload, seed, args.seconds, i < args.control_seeds,
                     device)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
