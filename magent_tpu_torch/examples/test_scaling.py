"""Scaling-efficiency harness: env-steps/s of the env loop at 1, 2, 4, ...
ranks with the env batch split over the mesh's ``dp`` axis (port of
``scripts/test/test_scaling.py``).

Each point starts ``n`` ranks through :mod:`.launch_multihost`'s launcher
(``--mode observe``: every group observed, random actions, transition, as
the JAX script's scanned loop), ``envs_per_device * n`` envs in all.  On
several cards this measures the 1 -> N weak-scaling efficiency (target:
>= 80%); ``--virtual N`` runs up to N gloo CPU ranks instead, which checks
the sharded program end to end, and its efficiency is only indicative
(the ranks share the host's cores).  From the repository root::

    python -m magent_tpu_torch.examples.test_scaling [--virtual 2]
"""

import argparse
import json

import torch

from magent_tpu_torch.examples import launch_multihost


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--map_size", type=int, default=200)
    parser.add_argument("--agents_per_env", type=int, default=2000)
    parser.add_argument("--envs_per_device", type=int, default=8)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--max_devices", type=int, default=0,
                        help="0 = all available")
    parser.add_argument("--virtual", type=int, default=0,
                        help="N gloo CPU ranks")
    return parser


def point(args, n):
    """One scaling point: ``n`` ranks -> {devices, env_steps_per_s,
    agent_steps_per_s}."""
    largs = launch_multihost.parse_args([
        "--nproc", str(n), "--mode", "observe",
        "--cpu_devices_per_proc", "1" if args.virtual else "0",
        "--map_size", str(args.map_size),
        "--agents_per_side", str(args.agents_per_env // 2),
        "--envs_per_device", str(args.envs_per_device),
        "--steps", str(args.steps), "--calls", "1"])
    out = launch_multihost.launch_local(largs, echo=False)
    rec = json.loads([line for line in out.splitlines()
                      if line.startswith("{")][-1])
    env_steps = rec["steps"] * rec["n_envs"]
    return dict(devices=n, env_steps_per_s=env_steps / rec["seconds"],
                agent_steps_per_s=env_steps * args.agents_per_env
                / rec["seconds"])


def main(argv=None):
    args = cli().parse_args(argv)
    n_dev_all = args.virtual or torch.cuda.device_count()
    if not n_dev_all:
        raise RuntimeError("no CUDA device: pass --virtual N for gloo CPU "
                           "ranks")
    max_dev = args.max_devices or n_dev_all

    results = []
    n = 1
    while n <= max_dev:
        results.append(point(args, n))
        print(json.dumps(results[-1]), flush=True)
        n *= 2

    if len(results) > 1:
        base = results[0]["env_steps_per_s"]
        last = results[-1]
        eff = last["env_steps_per_s"] / (base * last["devices"])
        print(json.dumps({
            "metric": "scaling_efficiency_1_to_%d" % last["devices"],
            "value": round(eff, 4),
            "unit": "fraction",
            "vs_baseline": round(eff / 0.8, 4),
        }), flush=True)
    return results


if __name__ == "__main__":
    main()
