"""Baseline sweep: run a port example over the algorithm grid {dqn, drqn,
a2c} and record wall time and log files (port of
``scripts/test/search.py``; parity with reference scripts/test/search.py).
Each run is ``python -m magent_tpu_torch.examples.<script> --train ...``
on ``--device``, with this package importable from any working directory;
``search.log`` gets one line per run.

    python -m magent_tpu_torch.tools.search [--script train_tiger.py]
        [--device cpu]
"""

import argparse
import os
import subprocess
import sys
import time

from ..parallel import resolve_device


def cli():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--script", default="train_tiger.py")
    parser.add_argument("--n_round", type=int, default=50)
    parser.add_argument("--map_size", type=int, default=64)
    parser.add_argument("--algs", nargs="*", default=["dqn", "drqn", "a2c"])
    parser.add_argument("--device", default=None,
                        help="the examples' device; default: the card "
                             "(raises without one)")
    return parser


def commands(args, device):
    """[(run name, command)] of the grid."""
    script = os.path.splitext(args.script)[0]
    out = []
    for alg in args.algs:
        name = "%s-%s" % (script, alg)
        out.append((name, [
            sys.executable, "-m", "magent_tpu_torch.examples." + script,
            "--train", "--n_round", str(args.n_round),
            "--map_size", str(args.map_size), "--alg", alg, "--name", name,
            "--device", str(device)]))
    return out


def main(argv=None):
    args = cli().parse_args(argv)
    device = resolve_device(args.device)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with open("search.log", "a") as rec:
        for (name, cmd), alg in zip(commands(args, device), args.algs):
            print(">>>", " ".join(cmd))
            start = time.time()
            ret = subprocess.run(cmd, env=env)
            wall = time.time() - start
            rec.write("log_file: %s.log\t legend: %s\t wall: %.1f\t code: %d\n"
                      % (name, alg, wall, ret.returncode))
            rec.flush()


if __name__ == "__main__":
    main()
