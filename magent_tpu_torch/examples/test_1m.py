"""Throughput test with random agents, up to one million (port of
``scripts/test/test_1m.py``; parity with reference scripts/test/test_1m.py:
forest config sized sqrt(20*n), random/DQN actors, per-phase timing, FPS
after 20 warm-up steps).

Two modes:
- default: the reference-style host loop over the stateful API, each phase
  a separate call with its own copy to or from the host;
- ``--vectorized``: the lockstep ``VecGridWorld`` loop ``observe_all ->
  random_actions -> transition`` over an env batch, eager (the JAX script
  fuses it in one ``jit`` + ``scan``), every view summed into a sink.

From the repository root::

    python -m magent_tpu_torch.examples.test_1m --agent_number 1000000
        [--vectorized --n_envs 1] [--device cpu]
"""

import argparse
import math
import time

import numpy as np
import torch

import magent_tpu_torch as magent
from magent_tpu_torch import random as rnd
from magent_tpu_torch.builtin.rule_model import RandomActor
from magent_tpu_torch.parallel import VecGridWorld


def load_forest(map_size):
    gw = magent.gridworld
    cfg = gw.Config()

    cfg.set({"map_width": map_size, "map_height": map_size})

    predator = cfg.register_agent_type(
        "predator",
        {'width': 2, 'length': 2, 'hp': 1, 'speed': 1,
         'view_range': gw.CircleRange(5), 'attack_range': gw.CircleRange(2),
         'attack_penalty': -0.2})

    prey = cfg.register_agent_type(
        "prey",
        {'width': 1, 'length': 1, 'hp': 1, 'speed': 1.5,
         'view_range': gw.CircleRange(4), 'attack_range': gw.CircleRange(0)})

    predator_group = cfg.add_group(predator)
    prey_group = cfg.add_group(prey)

    a = gw.AgentSymbol(predator_group, index='any')
    b = gw.AgentSymbol(prey_group, index='any')

    cfg.add_reward_rule(gw.Event(a, 'attack', b), receiver=[a, b], value=[1, -1])
    return cfg


class PhaseClock:
    """Accumulates wall time per named phase and prints a one-line summary
    per step (protocol contract: the reference harness times each phase of
    the host loop individually, reference scripts/test/test_1m.py:45-49)."""

    def __init__(self):
        self.totals = {}
        self.current = {}

    def __call__(self, phase, fn, *a):
        t0 = time.time()
        out = fn(*a)
        dt = time.time() - t0
        self.current[phase] = self.current.get(phase, 0.0) + dt
        self.totals[phase] = self.totals.get(phase, 0.0) + dt
        return out

    def flush(self):
        line = "  ".join("%s=%.4f" % kv for kv in self.current.items())
        self.current = {}
        return line


# protocol constants (reference scripts/test/test_1m.py): 20 warm-up steps
# before measurement; DQN mode uses one 100000-wide inference batch
WARMUP_STEPS = 20
DQN_INFER_BATCH = 100000


def host_world(args):
    """The host loop's world: ``sqrt(20 n)`` forest, n/10 random walls,
    then n/2 predators and n/2 prey at random -> (env, handles, seconds the
    placement took)."""
    n = args.agent_number
    env = magent.GridWorld(load_forest(int(math.sqrt(n * 20))),
                           device=args.device)
    env.reset()
    groups = env.get_handles()
    t0 = time.time()
    env.add_walls(method="random", n=n // 10)
    for h in groups:
        env.add_agents(h, method="random", n=n // 2)
    return env, groups, time.time() - t0


def run_host_loop(args):
    """Reference-style stateful-API loop: every phase is a separate call.
    -> {"steps": [(alive per group, reward sum)], "fps", "phase_totals",
    "place_s"}."""
    n = args.agent_number
    env, groups, place_s = host_world(args)
    print("placed %d walls and %d agents in %.2f s" % (n // 10, n, place_s))

    names = ("deer", "tiger")
    if args.num_gpu == 0:
        actors = [RandomActor(env, h, nm) for h, nm in zip(groups, names)]
    else:
        from magent_tpu_torch.builtin.torch_model import DeepQNetwork
        actors = [DeepQNetwork(env, h, nm, infer_batch_size=DQN_INFER_BATCH,
                               num_gpu=args.num_gpu, device=args.device)
                  for h, nm in zip(groups, names)]

    for h in groups:
        print("view_space", env.get_view_space(h))

    clock = PhaseClock()
    reward_sum = 0.0
    measured = 0.0
    measured_steps = 0
    done = False
    steps = []

    for i in range(args.n_step + WARMUP_STEPS):
        t0 = time.time()
        for h, actor, nm in zip(groups, actors, names):
            obs = clock("obs:" + nm, env.get_observation, h)
            acts = clock("act:" + nm, actor.infer_action, obs, None)
            clock("set:" + nm, env.set_action, h, acts)
        done = clock("step", env.step)
        rewards = clock("reward", env.get_reward, groups[1])
        reward_sum += float(sum(rewards))
        clock("clear", env.clear_dead)

        dt = time.time() - t0
        if i >= WARMUP_STEPS:
            measured += dt
            measured_steps += 1
        alive = [env.get_num(h) for h in groups]
        steps.append((alive, reward_sum))
        print("step %d  %.3fs  alive=%s  reward_sum=%.0f" %
              (i, dt, alive, reward_sum))
        print("  " + clock.flush())
        if done:
            print("episode ended")
            break

    print("phase totals: " +
          "  ".join("%s=%.3f" % kv for kv in sorted(clock.totals.items())))
    fps = None
    if measured_steps:
        fps = measured_steps * n / measured
        print("FPS", fps)
    else:
        print("episode ended during warm-up; no FPS measured")
    return dict(steps=steps, fps=fps, phase_totals=dict(clock.totals),
                place_s=place_s, env=env)


def vectorized_placements(args):
    """The vectorized mode's map and layout: per env n/n_envs agents on a
    ``sqrt(20 per_env)`` forest; n/10 interior walls rejection-sampled on
    free cells first, then 2x2 predators as free 2x2 blocks and 1x1 prey
    on free cells, all from ``RandomState(7)`` (test_1m.py:70-74; every
    env holds the same layout).  ``--no_walls`` omits the walls.  ->
    (map_size, per_env, preds, prey, walls)."""
    n_envs = args.n_envs
    per_env = max(args.agent_number // n_envs, 4)
    map_size = int(math.sqrt(per_env * 20))
    n_pred = per_env // 2
    n_prey = per_env - n_pred
    n_wall = 0 if args.no_walls else per_env // 10
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
    return map_size, per_env, preds, prey, walls


def vectorized_world(args):
    """-> (venv, map_size, per_env) of :func:`vectorized_placements`."""
    map_size, per_env, preds, prey, walls = vectorized_placements(args)
    venv = VecGridWorld(
        load_forest(map_size), [len(preds), len(prey)], n_envs=args.n_envs,
        placements=[preds, prey], walls=walls if walls else None,
        device=args.device)
    return venv, map_size, per_env


def sink_step(venv, carry, fast=False):
    """One ``observe_all -> random_actions -> transition`` step on ``carry
    = [state, key]`` (the JAX script's scan body) -> (the views' sink, the
    rewards [B, A], alive [B, A]).  Every view is summed into the sink, as
    the JAX script's full-view sink consumes every view of its banded
    route."""
    state, key = carry
    key, akey = rnd.split(key).unbind(-2)
    s = 0.0
    for view, _ in venv.observe_all(state):
        s = s + view.sum(dtype=torch.float32)
    actions = venv.random_actions(akey, fast=fast)
    state, rewards, alive, _ = venv.transition(state, actions)
    carry[:] = [state, key]
    return s + rewards[:, 0].sum(), rewards, alive


def run_vectorized(args):
    """The lockstep loop: ``n_step`` steps to warm up, then ``n_step``
    timed ones ending in the sink's read -> {"fps", "env_steps_per_s",
    "map_size", "per_env", "venv", "state"}."""
    venv, map_size, per_env = vectorized_world(args)
    n_envs = args.n_envs
    carry = [venv.reset(rnd.PRNGKey(0, venv.device)),
             rnd.PRNGKey(1, venv.device)]

    def run():
        sink = 0.0
        for _ in range(args.n_step):
            sink = sink + sink_step(venv, carry, args.fast_rand)[0]
        return float(sink)

    run()  # warm up
    start = time.time()
    run()
    dt = time.time() - start
    steps = args.n_step * n_envs
    print("map %dx%d, %d envs x %d agents" % (map_size, map_size, n_envs, per_env))
    print("env-steps/s %.1f" % (steps / dt))
    print("FPS %.1f" % (steps * per_env / dt))
    return dict(fps=steps * per_env / dt, env_steps_per_s=steps / dt,
                map_size=map_size, per_env=per_env, venv=venv,
                state=carry[0])


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_step", type=int, default=20)
    parser.add_argument("--agent_number", type=int, default=1000)
    parser.add_argument("--num_gpu", type=int, default=0,
                        help="0: random actors; n >= 1: DQN actors, their "
                             "inference sharded over n local devices "
                             "(DeepQNetwork num_gpu, capped at the "
                             "devices there are)")
    parser.add_argument("--n_envs", type=int, default=16)
    parser.add_argument("--unroll", type=int, default=1,
                        help="accepted for the JAX script's command lines; "
                             "the eager loop has no scan to unroll")
    parser.add_argument("--vectorized", action="store_true")
    parser.add_argument("--fast_rand", action="store_true",
                        help="counter-based uniform actions instead of "
                             "threefry (vec_env.random_actions fast=True)")
    parser.add_argument("--no_walls", action="store_true",
                        help="omit the protocol's n/10 interior walls "
                             "(rounds 2-4 measured this layout)")
    parser.add_argument("--frame", default="jax", choices=["jax", "tf", "mx"])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    return parser


def main(argv=None):
    args = cli().parse_args(argv)
    if args.vectorized:
        return run_vectorized(args)
    return run_host_loop(args)


if __name__ == "__main__":
    main()
