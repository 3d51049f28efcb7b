"""Per-phase cost ladder at the FPS-sweep geometries (port of
``scripts/profile_sweep.py``): the forest config at map side
sqrt(20 * per_env), n/2 2x2 predators and n/2 prey, n/10 interior walls
(``scripts/test/test_1m.py``'s protocol), placed from ``RandomState(7)``.

The variants are ``tools.profile_phases``' on this world, timed the same
way (CUDA events; a warm-up call, then ``--calls`` calls of ``--steps``
steps from the same start).  Where a group's views take the banded
gather, the sink reads every view element, as the JAX script's does.

    python -m magent_tpu_torch.tools.profile_sweep --agent_number 100000
        --n_envs 16 [variants ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from .. import random as rnd
from ..examples.test_1m import load_forest
from ..parallel import VecGridWorld, resolve_device
from . import profile_phases as pp

VARIANTS = ("full", "obs_only", "step_only", "attack_only", "move_only",
            "grids_only")


def build_venv(agent_number, n_envs, no_walls=False, device=None):
    """``profile_sweep.py:37-78``'s world -> (venv, agents per env,
    walls)."""
    per_env = max(agent_number // n_envs, 4)
    map_size = int(math.sqrt(per_env * 20))
    cfg = load_forest(map_size)
    n_pred = per_env // 2
    n_prey = per_env - n_pred
    n_wall = 0 if no_walls else per_env // 10
    rng = np.random.RandomState(7)
    taken = set()
    walls = []
    while len(walls) < n_wall:
        x = int(rng.randint(1, map_size - 1))
        y = int(rng.randint(1, map_size - 1))
        if (x, y) not in taken:
            taken.add((x, y))
            walls.append([x, y])
    preds = []
    while len(preds) < n_pred:
        x = int(rng.randint(1, map_size - 3))
        y = int(rng.randint(1, map_size - 3))
        block = [(x + dx, y + dy) for dx in range(2) for dy in range(2)]
        if not any(c in taken for c in block):
            taken.update(block)
            preds.append([x, y, 0])
    prey = []
    while len(prey) < n_prey:
        x = int(rng.randint(1, map_size - 2))
        y = int(rng.randint(1, map_size - 2))
        if (x, y) not in taken:
            taken.add((x, y))
            prey.append([x, y, 0])
    venv = VecGridWorld(cfg, [n_pred, n_prey], n_envs=n_envs,
                        placements=[preds, prey],
                        walls=walls if walls else None, device=device)
    print("map %dx%d, %d envs x %d agents (cap %d), %d interior walls"
          % (map_size, map_size, n_envs, per_env, venv.spec.n_agents_cap,
             n_wall), flush=True)
    return venv, per_env, walls


def cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--agent_number", type=int, default=100000)
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--no_walls", action="store_true")
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help="of %s" % " ".join(VARIANTS))
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    return ap


def main(argv=None):
    """-> {variant: (ms per step, sink)}."""
    ap = cli()
    args = ap.parse_args(argv)
    if set(args.variants) - set(VARIANTS):
        ap.error("variants are %s" % " ".join(VARIANTS))
    device = resolve_device(args.device)
    venv, per_env, walls = build_venv(args.agent_number, args.n_envs,
                                      args.no_walls, device)
    route = venv._step.route
    print("engine path: grid=%s quad=%s seg=%s" % route, flush=True)
    # banded views are read in full: the sink must depend on every window
    full_sink = any(o.route == "window_gather_banded" for o in venv._observe)

    def full(venv, state, key):
        key, akey = rnd.split(key).unbind(-2)
        s = pp.obs_sink(venv, state, full_sink)
        state, rewards, alive, done = venv.transition(
            state, venv.random_actions(akey))
        return state, key, s + rewards[:, 0].sum()

    def obs_only(venv, state, key):
        return pp.nudged(state), key, pp.obs_sink(venv, state, full_sink)

    bodies = pp.variant_bodies(venv, [v for v in args.variants
                                      if v not in ("full", "obs_only")],
                               pp.phase_context(venv, walls))
    bodies.update({"full": (venv, full), "obs_only": (venv, obs_only)})
    state = venv.reset(rnd.PRNGKey(0, device))
    key = rnd.PRNGKey(1, device)
    results = {}
    with torch.no_grad():
        for name in args.variants:
            if name not in bodies:
                continue
            v, body = bodies[name]
            results[name] = pp.timed(name, v, body, state, key, args.steps,
                                     args.calls, per_env * args.n_envs)
    return results


if __name__ == "__main__":
    main()
