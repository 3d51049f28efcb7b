"""Throughput benchmark: battle, 2x1000 agents (port of the root
``bench.py``).

Measures agent-steps/s of the full environment loop: observation rendering
for both groups, the random policy, the step and the reward extraction, over
a batch of lockstep envs on one card.  The JAX script fuses the loop into one
jitted ``lax.scan``; here it runs as the same eager loop, and the host reads
the sink once after the timed calls (``bench.py:83-87``'s ``float(sink)``).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
``vs_baseline`` is value / 10M agent-steps/s, the JAX script's divisor (the
multi-host target of BASELINE.md).  The JAX script's ``BENCH_N_ENVS``,
``BENCH_STEPS`` and ``BENCH_CALLS`` are ``--n_envs``, ``--steps`` and
``--calls`` here.

    python -m magent_tpu_torch.tools.bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import random as rnd
from ..builtin.config import battle
from ..parallel import VecGridWorld, resolve_device

N_PER_GROUP = 1000
MAP_SIZE = 200  # reference sweep sizing: side = sqrt(20 * n_agents)


def cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=64,
                    help="env steps per timed call")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    return ap


def build(args, device):
    """The benchmark's ``VecGridWorld`` (f32 views, ``bench.py:40-46``)."""
    return VecGridWorld(battle.get_config(MAP_SIZE),
                        [N_PER_GROUP, N_PER_GROUP], n_envs=args.n_envs,
                        device=device)


def body(venv, state, key):
    """One loop step (``bench.py:49-59``) -> (state, key, sink): the sink
    reads one value of every agent's window and features and env 0's first
    reward, so no part of the step can be skipped."""
    key, akey = rnd.split(key).unbind(-2)
    obs_sum = 0.0
    for view, feat in venv.observe_all(state):
        obs_sum = obs_sum + view[:, :, 0, 0, 0].sum() + feat[:, 0, 0].sum()
    actions = venv.random_actions(akey)
    state, rewards, alive, done = venv.transition(state, actions)
    return state, key, obs_sum + rewards[:, 0].sum()


@torch.no_grad()
def run(venv, state, key, steps, step=body):
    """``steps`` loop steps -> (state, key, summed sink on the device)."""
    sinks = []
    for _ in range(steps):
        state, key, s = step(venv, state, key)
        sinks.append(s)
    return state, key, torch.stack(sinks).sum()


def main(argv=None):
    """-> {"record": the printed JSON, "state", "sink"} of the last call."""
    args = cli().parse_args(argv)
    device = resolve_device(args.device)
    venv = build(args, device)
    state = venv.reset(rnd.PRNGKey(0, device))
    key = rnd.PRNGKey(1, device)

    state, key, sink = run(venv, state, key, args.steps)  # warm-up
    float(sink)

    t0 = time.perf_counter()
    for _ in range(args.calls):
        state, key, sink = run(venv, state, key, args.steps)
    float(sink)
    dt = time.perf_counter() - t0

    agent_steps = 2 * N_PER_GROUP * args.n_envs * args.steps * args.calls
    value = agent_steps / dt
    record = {
        "metric": "battle_2x1000_agent_steps_per_s",
        "value": round(value, 1),
        "unit": "agent-steps/s",
        "vs_baseline": round(value / 1e7, 4),
    }
    print(json.dumps(record), flush=True)
    return {"record": record, "state": state, "sink": float(sink)}


if __name__ == "__main__":
    main()
