"""Pursuit throughput (port of ``scripts/bench_pursuit.py``; reference
scale: examples/train_pursuit.py:18-20,109 — one map-1000 world, predators
= 1.25% of cells as 2x2 bodies, prey = 2.5%).

Modes:
- default: the shipped pursuit config (turn_mode off: the NORTH-only
  observation and the gridless rect engine, on the y-segmented sweeps and
  the banded window gather at map 1000);
- ``--turn``: the same geometry with turn_mode=True: the stacked-rotations
  window path.  The JAX script's ``MAGENT_OBS_KERNEL=xla`` (its legacy
  per-direction gather, for a kernel-vs-XLA ratio) has no switch here: the
  port picks its observation route from the geometry alone.

Prints agent-steps/s over the obs -> act -> step loop, run eagerly (the
JAX script scans it in one jitted program) and read once after the timed
call.

    python -m magent_tpu_torch.tools.bench_pursuit [--turn] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from .. import random as rnd
from ..parallel import VecGridWorld, resolve_device


def pursuit_config(map_size, turn):
    from .. import gridworld as gw

    cfg = gw.Config()
    cfg.set({"map_width": map_size, "map_height": map_size})
    if turn:
        cfg.set({"turn_mode": True})
    predator = cfg.register_agent_type(
        "predator",
        {'width': 2, 'length': 2, 'hp': 1, 'speed': 1,
         'view_range': gw.CircleRange(5), 'attack_range': gw.CircleRange(2),
         'attack_penalty': -0.2})
    prey = cfg.register_agent_type(
        "prey",
        {'width': 1, 'length': 1, 'hp': 1, 'speed': 1.5,
         'view_range': gw.CircleRange(4), 'attack_range': gw.CircleRange(0)})
    g0 = cfg.add_group(predator)
    g1 = cfg.add_group(prey)
    a = gw.AgentSymbol(g0, index='any')
    b = gw.AgentSymbol(g1, index='any')
    cfg.add_reward_rule(gw.Event(a, 'attack', b), receiver=[a, b],
                        value=[1, -1])
    return cfg


def placements(map_size, n_pred, n_prey, turn, seed=5):
    """2x2 predators (facing at random in turn mode), then prey, on free
    cells drawn from ``RandomState(seed)`` (``bench_pursuit.py:52-70``)."""
    rng = np.random.RandomState(seed)
    taken = set()
    preds, prey = [], []
    while len(preds) < n_pred:
        x = int(rng.randint(1, map_size - 3))
        y = int(rng.randint(1, map_size - 3))
        block = [(x + dx, y + dy) for dx in range(2) for dy in range(2)]
        if not any(c in taken for c in block):
            taken.update(block)
            preds.append([x, y, rng.randint(4) if turn else 0])
    while len(prey) < n_prey:
        x = int(rng.randint(1, map_size - 2))
        y = int(rng.randint(1, map_size - 2))
        if (x, y) not in taken:
            taken.add((x, y))
            prey.append([x, y, 0])
    return [preds, prey]


def populations(map_size):
    """(predators, prey): 1.25% and 2.5% of the cells."""
    n = map_size * map_size
    return int(n * 0.0125), int(n * 0.025)


def cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--map_size", type=int, default=1000)
    ap.add_argument("--n_envs", type=int, default=1)
    ap.add_argument("--n_step", type=int, default=20)
    ap.add_argument("--turn", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    return ap


def build(args, device):
    m = args.map_size
    n_pred, n_prey = populations(m)
    return VecGridWorld(pursuit_config(m, args.turn), [n_pred, n_prey],
                        n_envs=args.n_envs, device=device,
                        placements=placements(m, n_pred, n_prey, args.turn))


@torch.no_grad()
def run(venv, state, key, n_step):
    """``n_step`` steps of ``bench_pursuit.py:86-95``'s body -> (state,
    key, summed sink on the device)."""
    sinks = []
    for _ in range(n_step):
        key, akey = rnd.split(key).unbind(-2)
        s = 0.0
        for view, feat in venv.observe_all(state):
            s = s + view[:, 0, 0, 0, 0].sum()
        actions = venv.random_actions(akey)
        state, rewards, alive, done = venv.transition(state, actions)
        sinks.append(s + rewards[:, 0].sum())
    return state, key, torch.stack(sinks).sum()


def main(argv=None):
    """-> {"rate": agent-steps/s, "state", "sink"} of the timed call."""
    args = cli().parse_args(argv)
    device = resolve_device(args.device)
    venv = build(args, device)
    m = args.map_size
    state = venv.reset(rnd.PRNGKey(0, device))
    key = rnd.PRNGKey(1, device)
    state, key, sink = run(venv, state, key, args.n_step)
    float(sink)  # warm up

    start = time.time()
    state, key, sink = run(venv, state, key, args.n_step)
    float(sink)
    dt = time.time() - start
    per_env = sum(populations(m))
    steps = args.n_step * args.n_envs
    print("pursuit%s map %d, %d envs x %d agents (obs_kernel=auto)"
          % (" TURN" if args.turn else "", m, args.n_envs, per_env))
    rate = steps * per_env / dt
    print("agent-steps/s %.1f" % rate)
    return {"rate": rate, "state": state, "sink": float(sink)}


if __name__ == "__main__":
    main()
