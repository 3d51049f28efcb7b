"""Round-robin tournament between saved checkpoint generations (port of
``scripts/tournament.py``; parity with reference scripts/tournament.py).
Checkpoints are the JAX package's files (``<savedir>/<name>/tfdqn_<epoch>
.npz``), so either package plays either package's generations::

    python -m magent_tpu_torch.examples.tournament --name battle-l
        [--device cpu]
"""

import argparse
import math
import os
import re

import magent_tpu_torch as magent
from magent_tpu_torch.builtin.torch_model import DeepQNetwork


def play(env, handles, models, map_size, leftID, rightID, eps=0.05,
         max_steps=550):
    """One evaluation game: battle start squares, near-greedy play, returns
    the surviving head-count per group."""
    env.reset()
    side_len = int(math.sqrt(map_size * map_size * 0.04)) * 2
    gap = 3
    y0 = (map_size - side_len) // 2

    def square(x0):
        return [[x, y, 0]
                for x in range(x0, x0 + side_len, 2)
                for y in range(y0, y0 + side_len, 2)]

    env.add_agents(handles[leftID], method="custom",
                   pos=square(map_size // 2 - gap - side_len))
    env.add_agents(handles[rightID], method="custom",
                   pos=square(map_size // 2 + gap))

    survivors = [env.get_num(h) for h in handles]
    for _ in range(max_steps):
        for handle, model in zip(handles, models):
            view_feat = env.get_observation(handle)
            ids = env.get_agent_id(handle)
            env.set_action(
                handle, model.infer_action(view_feat, ids, 'e_greedy', eps))
        done = env.step()
        survivors = [env.get_num(h) for h in handles]
        env.clear_dead()
        if done:
            break
    return survivors


def extract_checkpoints(savedir, name, begin=0, pick_every=4):
    """list saved epochs of a model (checkpoints are <subclass>_<epoch>.npz)"""
    pattern = re.compile(r"tfdqn_(\d+)\.npz")
    ret = []
    for path in os.listdir(os.path.join(savedir, name)):
        match = pattern.match(path)
        if match and int(match.group(1)) >= begin:
            ret.append(int(match.group(1)))
    ret.sort()  # numeric generation order (reference: tournament.py:81)
    return ret[::pick_every]


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--map_size", type=int, default=125)
    parser.add_argument("--name", type=str, default="battle-l")
    parser.add_argument("--savedir", type=str, default="save_model")
    parser.add_argument("--begin", type=int, default=0)
    parser.add_argument("--pick_every", type=int, default=4)
    parser.add_argument("--n_game", type=int, default=10,
                        help="games per pairing (sides swap each game); "
                             "games differ through the eps-greedy draw")
    parser.add_argument("--max_steps", type=int, default=550,
                        help="per-game step cap (the battle episode cap)")
    parser.add_argument("--eps", type=float, default=0.05)
    parser.add_argument("--device", default=None,
                        help="default: the card (raises without one)")
    return parser


def main(argv=None):
    """-> {(epoch a, epoch b): (score, draws)}."""
    args = cli().parse_args(argv)
    env = magent.GridWorld("battle", map_size=args.map_size,
                           device=args.device)
    handles = env.get_handles()

    epochs = extract_checkpoints(args.savedir, args.name,
                                 args.begin, args.pick_every)
    print("checkpoint epochs:", epochs)
    if len(epochs) < 2:
        print("need at least two checkpoints for a tournament")
        return {}

    models = [DeepQNetwork(env, handles[0], "p0", memory_size=2 ** 10,
                           device=args.device),
              DeepQNetwork(env, handles[1], "p1", memory_size=2 ** 10,
                           device=args.device)]

    game_wins = {e: 0 for e in epochs}
    games_played = {e: 0 for e in epochs}
    pair_wins = {e: 0 for e in epochs}
    results = {}
    for i, e_a in enumerate(epochs):
        for e_b in epochs[i + 1:]:
            models[0].load(args.savedir, e_a, name=args.name)
            models[1].load(args.savedir, e_b, name=args.name)
            score = [0, 0]
            draws = 0
            for g in range(args.n_game):
                left, right = (0, 1) if g % 2 == 0 else (1, 0)
                nums = play(env, handles, models, args.map_size, left, right,
                            eps=args.eps, max_steps=args.max_steps)
                if nums[0] > nums[1]:
                    score[0] += 1
                elif nums[1] > nums[0]:
                    score[1] += 1
                else:
                    draws += 1
            print("epoch %d vs %d -> %d : %d (%d draws)"
                  % (e_a, e_b, score[0], score[1], draws), flush=True)
            results[e_a, e_b] = (tuple(score), draws)
            game_wins[e_a] += score[0]
            game_wins[e_b] += score[1]
            games_played[e_a] += args.n_game
            games_played[e_b] += args.n_game
            if score[0] > score[1]:
                pair_wins[e_a] += 1
            elif score[1] > score[0]:
                pair_wins[e_b] += 1

    print("\n===== standings =====")
    print("%10s  %9s  %8s  %s" % ("epoch", "game wins", "win rate",
                                  "pairings won"))
    for e in sorted(epochs, key=lambda k: (-game_wins[k], -pair_wins[k])):
        rate = game_wins[e] / max(games_played[e], 1)
        print("%10d  %9d  %7.0f%%  %d"
              % (e, game_wins[e], 100 * rate, pair_wins[e]))
    return results


if __name__ == "__main__":
    main()
