"""Integration smoke test: run every training example for one round on the
port of the JAX model family (``--backend jax``), then rerun the set on
the second backend (``--backend torch``) (port of
``scripts/test/test_examples.py``; parity with the reference harness, which
sed-swaps tf_model -> mx_model and reruns every example: reference
scripts/test/test_examples.py:16-31).  Each example runs as
``python -m magent_tpu_torch.examples.<name>``.  From the repository
root::

    python -m magent_tpu_torch.examples.test_examples [--device cpu]
"""

import argparse
import os
import subprocess
import sys

# the repository root: the examples run as modules of the package
ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", ".."))

candidates = [
    ("train_battle", ["--train", "--n_round", "1", "--map_size", "32"]),
    ("train_single", ["--train", "--n_round", "1", "--map_size", "32"]),
    ("train_against", ["--train", "--n_round", "1", "--map_size", "32"]),
    ("train_multi", ["--train", "--n_round", "1", "--map_size", "32"]),
    ("train_pursuit", ["--train", "--n_round", "1", "--map_size", "64"]),
    ("train_tiger", ["--train", "--n_round", "1", "--map_size", "64"]),
    ("train_gather", ["--train", "--n_round", "1", "--map_size", "50"]),
    ("train_trans", ["--train", "--n_round", "1", "--map_size", "32"]),
    ("train_arrange", ["--train", "--n_round", "1", "--map_size", "48",
                       "--message", "HI"]),
]


def module_env():
    """The environment of a child run: the repository root on
    ``PYTHONPATH``, so that ``-m magent_tpu_torch...`` resolves from any
    working directory."""
    env = dict(os.environ)
    paths = [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p]
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


def command(name, extra, backend, device=None):
    cmd = [sys.executable, "-m", "magent_tpu_torch.examples." + name] + \
        extra + ["--backend", backend]
    return cmd + (["--device", device] if device else [])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", default="jax,torch",
                    help="comma-separated backend list to sweep")
    ap.add_argument("--device", default=None,
                    help="torch device of every run (default: the GPU)")
    args = ap.parse_args(argv)

    env = module_env()
    failed = []
    for backend in args.backends.split(","):
        for name, extra in candidates:
            cmd = command(name, extra, backend, args.device)
            print(">>>", " ".join(cmd))
            ret = subprocess.run(cmd, env=env)
            if ret.returncode != 0:
                failed.append(f"{name} [{backend}]")
    if failed:
        print("FAILED:", failed)
        return 1
    print("all examples passed on all backends")
    return 0


if __name__ == "__main__":
    sys.exit(main())
