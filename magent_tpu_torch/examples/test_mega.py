"""Mega-battle: one million agents stepping in lockstep on one card (port
of ``scripts/test/test_mega.py``).

The population is split over env instances at the density of the
reference's FPS sweep (map = sqrt(20 n) per env, scripts/test/test_1m.py:66).
The loop ``[observe_all ->] random_actions -> transition`` runs eagerly
(the JAX script fuses it in one ``jit`` + ``scan``); with ``--observe``
every view is summed into a sink.  From the repository root::

    python -m magent_tpu_torch.examples.test_mega --observe
        [--obs_dtype bf16] [--device cpu]
"""

import argparse
import json
import math
import time

import torch

import magent_tpu_torch as magent
from magent_tpu_torch import random as rnd
from magent_tpu_torch.parallel import VecGridWorld


def battle_cfg(map_size):
    gw = magent.gridworld
    cfg = gw.Config()
    cfg.set({"map_width": map_size, "map_height": map_size})
    cfg.set({"embedding_size": 10})
    small = cfg.register_agent_type(
        "small",
        {'width': 1, 'length': 1, 'hp': 10, 'speed': 2,
         'view_range': gw.CircleRange(6), 'attack_range': gw.CircleRange(1.5),
         'damage': 2, 'step_recover': 0.1,
         'step_reward': -0.005, 'kill_reward': 5, 'dead_penalty': -0.1,
         'attack_penalty': -0.1})
    g0 = cfg.add_group(small)
    g1 = cfg.add_group(small)
    a = gw.AgentSymbol(g0, index='any')
    b = gw.AgentSymbol(g1, index='any')
    cfg.add_reward_rule(gw.Event(a, 'attack', b), receiver=a, value=0.2)
    cfg.add_reward_rule(gw.Event(b, 'attack', a), receiver=b, value=0.2)
    return cfg


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--agents", type=int, default=1000000)
    parser.add_argument("--n_envs", type=int, default=64)
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--observe", action="store_true",
                        help="include observation rendering in the loop")
    parser.add_argument("--obs_dtype", default="f32", choices=["f32", "bf16"],
                        help="window store dtype (bf16 halves the ~3.4GB of "
                             "window writes per 1M-agent obs pass)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    return parser


def world(args):
    """-> (venv, map_size, per_env) of ``args``."""
    per_env = args.agents // args.n_envs
    map_size = int(math.sqrt(per_env * 20))
    venv = VecGridWorld(battle_cfg(map_size), [per_env // 2, per_env // 2],
                        n_envs=args.n_envs,
                        obs_dtype={"f32": None, "bf16": torch.bfloat16}[
                            args.obs_dtype], device=args.device)
    return venv, map_size, per_env


def mega_step(venv, carry, observe):
    """One step on ``carry = [state, key]`` (the JAX script's scan body) ->
    the sink: every view summed (with ``observe``) plus group 0's first
    reward per env."""
    state, key = carry
    key, akey = rnd.split(key).unbind(-2)
    s = 0.0
    if observe:
        for view, _ in venv.observe_all(state):
            s = s + view.sum(dtype=torch.float32)
    acts = venv.random_actions(akey)
    state, rew, _, _ = venv.transition(state, acts)
    carry[:] = [state, key]
    return s + rew[:, 0].sum()


def main(argv=None):
    args = cli().parse_args(argv)
    venv, map_size, per_env = world(args)
    print("%d envs x %d agents on %dx%d maps (%.2fM total)" %
          (args.n_envs, per_env, map_size, map_size,
           args.n_envs * per_env / 1e6))
    carry = [venv.reset(rnd.PRNGKey(0, venv.device)),
             rnd.PRNGKey(1, venv.device)]

    def run():
        sink = 0.0
        for _ in range(args.steps):
            sink = sink + mega_step(venv, carry, args.observe)
        return float(sink)

    t0 = time.perf_counter()
    run()
    print("first run: %.1f s" % (time.perf_counter() - t0))

    t0 = time.perf_counter()
    sink = run()
    dt = time.perf_counter() - t0

    agent_steps = args.steps * args.n_envs * (per_env // 2) * 2
    out = {
        "metric": "mega_battle_agent_steps_per_s",
        "value": round(agent_steps / dt, 1),
        "unit": "agent-steps/s",
        "vs_baseline": round(agent_steps / dt / 1e7, 4),
    }
    print(json.dumps(out))
    return dict(out, sink=sink, seconds=dt, map_size=map_size,
                per_env=per_env, venv=venv)


if __name__ == "__main__":
    main()
