"""Head-to-head evaluation: a checkpointed DQN vs an untrained or random
opponent on the battle map (port of ``scripts/eval_checkpoint.py``).
Reports survivors per game: quick evidence that training produced behavior
beyond random.  Checkpoints are the JAX package's files (either package
loads either package's), e.g. the bundled ``data/models``::

    python -m magent_tpu_torch.examples.eval_checkpoint
        --savedir data/models --name trusty-battle-game-l [--device cpu]
"""

import argparse
import math
from types import SimpleNamespace

import magent_tpu_torch as magent
from magent_tpu_torch.builtin.rule_model import RandomActor
from magent_tpu_torch.builtin.torch_model import DeepQNetwork
from magent_tpu_torch.builtin.torch_model.base import latest_epoch


def generate_map(env, map_size, handles):
    init_num = map_size * map_size * 0.04
    gap = 3
    side = int(math.sqrt(init_num)) * 2
    for idx, x0 in ((0, map_size // 2 - gap - side), (1, map_size // 2 + gap)):
        pos = []
        for x in range(x0, x0 + side, 2):
            for y in range((map_size - side) // 2,
                           (map_size - side) // 2 + side, 2):
                pos.append([x, y, 0])
        env.add_agents(handles[idx], method="custom", pos=pos)


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--name", default="battle-fused-l")
    parser.add_argument("--savedir", default="save_model")
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--map_size", type=int, default=64)
    parser.add_argument("--n_games", type=int, default=4)
    parser.add_argument("--max_steps", type=int, default=400)
    parser.add_argument("--opponent", choices=["random", "untrained"],
                        default="untrained")
    parser.add_argument("--device", default=None,
                        help="default: the card (raises without one)")
    return parser


def setup(args):
    """The battle world and the two sides' models -> a namespace."""
    env = magent.GridWorld("battle", map_size=args.map_size,
                           device=args.device)
    h0, h1 = env.get_handles()
    trained = DeepQNetwork(env, h0, "trained", memory_size=2 ** 10,
                           device=args.device)
    ep = args.epoch if args.epoch is not None else latest_epoch(
        args.savedir, args.name)
    assert ep is not None, "no checkpoint found for %s" % args.name
    trained.load(args.savedir, ep, args.name)
    print("loaded %s epoch %d" % (args.name, ep))
    if args.opponent == "random":
        opponent = RandomActor(env, h1)
    else:
        opponent = DeepQNetwork(env, h1, "untrained", memory_size=2 ** 10,
                                device=args.device)
    return SimpleNamespace(env=env, handles=(h0, h1), trained=trained,
                           opponent=opponent)


def play(ex, args):
    """``args.n_games`` games -> [(survivors, starting counts, steps)]."""
    env, (h0, h1) = ex.env, ex.handles
    wins, games = 0, []
    for game in range(args.n_games):
        env.reset()
        generate_map(env, args.map_size, (h0, h1))
        n0_start, n1_start = env.get_num(h0), env.get_num(h1)
        done, step = False, 0
        while not done and step < args.max_steps:
            for h, model in ((h0, ex.trained), (h1, ex.opponent)):
                obs = env.get_observation(h)
                ids = env.get_agent_id(h)
                acts = model.infer_action(obs, ids, "e_greedy", eps=0.05)
                env.set_action(h, acts)
            done = env.step()
            env.clear_dead()
            step += 1
        n0, n1 = env.get_num(h0), env.get_num(h1)
        result = "WIN" if n0 > n1 else ("LOSS" if n1 > n0 else "DRAW")
        wins += n0 > n1
        games.append(((n0, n1), (n0_start, n1_start), step))
        print("game %d: trained %d/%d vs opponent %d/%d after %d steps -> %s"
              % (game, n0, n0_start, n1, n1_start, step, result))
    print("trained side won %d / %d games" % (wins, args.n_games))
    return games


def main(argv=None):
    args = cli().parse_args(argv)
    return play(setup(args), args)


if __name__ == "__main__":
    main()
