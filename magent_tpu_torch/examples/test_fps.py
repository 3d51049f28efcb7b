"""FPS sweep over agent counts (port of ``scripts/test/test_fps.py``;
parity with reference scripts/test/test_fps.py: n in {1e3, 1e4, 1e5, 1e6}
with a fixed 30M agent-step budget), each size a run of :mod:`.test_1m`.
From the repository root::

    python -m magent_tpu_torch.examples.test_fps [--vectorized] [--device cpu]
"""

import argparse
import subprocess
import sys

from magent_tpu_torch.examples.test_examples import module_env


def command(n_agents, budget, vectorized, device=None):
    n_step = max(budget // n_agents, 4)
    cmd = [sys.executable, "-m", "magent_tpu_torch.examples.test_1m",
           "--agent_number", str(n_agents), "--n_step", str(n_step)]
    if vectorized:
        cmd.append("--vectorized")
    if device:
        cmd += ["--device", device]
    return cmd


def run_one(n_agents, budget, vectorized, device=None):
    cmd = command(n_agents, budget, vectorized, device)
    print(">>>", " ".join(cmd))
    subprocess.run(cmd, check=True, env=module_env())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--budget", type=int, default=30000000,
                        help="agent-step budget per configuration")
    parser.add_argument("--vectorized", action="store_true")
    parser.add_argument("--sizes", type=int, nargs="*",
                        default=[1000, 10000, 100000, 1000000])
    parser.add_argument("--device", default=None,
                        help="torch device of each run (default: the GPU)")
    args = parser.parse_args(argv)

    for n in args.sizes:
        run_one(n, args.budget, args.vectorized, args.device)


if __name__ == "__main__":
    main()
