"""Baseline sweep of train_against over the algorithm grid (port of
``scripts/test/test_against.py``; parity with reference
scripts/test/test_against.py).  From the repository root::

    python -m magent_tpu_torch.examples.test_against [N_ROUND] [--device cpu]
"""

import argparse
import subprocess
import sys
import time

from magent_tpu_torch.examples.test_examples import module_env


def command(alg, n_round, device=None):
    name = "against-%s" % alg
    cmd = [sys.executable, "-m", "magent_tpu_torch.examples.train_against",
           "--train", "--n_round", n_round, "--alg", alg, "--name", name]
    return name, cmd + (["--device", device] if device else [])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_round", nargs="?", default="50")
    ap.add_argument("--device", default=None,
                    help="torch device of every run (default: the GPU)")
    args = ap.parse_args(argv)

    env = module_env()
    with open("test_against.log", "a") as rec:
        for alg in ["dqn", "drqn", "a2c"]:
            name, cmd = command(alg, args.n_round, args.device)
            print(">>>", " ".join(cmd))
            start = time.time()
            ret = subprocess.run(cmd, env=env)
            rec.write("log_file: %s.log\t legend: %s\t wall: %.1f\t code: %d\n"
                      % (name, alg, time.time() - start, ret.returncode))
            rec.flush()


if __name__ == "__main__":
    main()
