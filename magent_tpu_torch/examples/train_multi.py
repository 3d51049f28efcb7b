"""Train a 4-group battle: two armies, each fielding a melee and a ranged
unit type (port of ``examples/train_multi.py``; capability parity with
reference examples/train_multi.py).  From the repository root::

    python -m magent_tpu_torch.examples.train_multi --train [--device cpu]
"""

import logging
import math
import time
from types import SimpleNamespace

import magent_tpu_torch as magent
from magent_tpu_torch.examples.rollout import (EpisodeRunner, Side, build_alg,
                                               load_checkpoints,
                                               save_checkpoints, standard_cli)


def load_config(map_size):
    gw = magent.gridworld
    cfg = gw.Config()

    cfg.set({"map_width": map_size, "map_height": map_size})
    cfg.set({"minimap_mode": True})
    cfg.set({"embedding_size": 10})

    melee = cfg.register_agent_type(
        "melee",
        {'width': 1, 'length': 1, 'hp': 10, 'speed': 1,
         'view_range': gw.CircleRange(6), 'attack_range': gw.CircleRange(1),
         'damage': 2, 'step_recover': 0.1, 'attack_in_group': True,
         'step_reward': -0.01, 'kill_reward': 0, 'dead_penalty': -0.1,
         'attack_penalty': -1,
         })

    ranged = cfg.register_agent_type(
        "ranged",
        {'width': 1, 'length': 1, 'hp': 3, 'speed': 2,
         'view_range': gw.CircleRange(6), 'attack_range': gw.CircleRange(2),
         'damage': 2, 'step_recover': 0.1, 'attack_in_group': True,
         'step_reward': -0.01, 'kill_reward': 0, 'dead_penalty': -0.1,
         'attack_penalty': -1,
         })

    armies = [(cfg.add_group(melee), cfg.add_group(ranged)),
              (cfg.add_group(melee), cfg.add_group(ranged))]

    # shaping: reward attacking or killing any unit of the opposing army
    for us, them in ((armies[0], armies[1]), (armies[1], armies[0])):
        for me in us:
            mine = gw.AgentSymbol(me, index='any')
            for foe in them:
                theirs = gw.AgentSymbol(foe, index='any')
                cfg.add_reward_rule(gw.Event(mine, 'attack', theirs),
                                    receiver=mine, value=2)
                cfg.add_reward_rule(gw.Event(mine, 'kill', theirs),
                                    receiver=mine, value=100)

    return cfg


def generate_map(env, map_size, handles):
    """Each army forms a square; its two unit types interleave by column."""
    n_init = int(map_size * map_size * 0.04)
    side_len = int(math.sqrt(n_init)) * 2
    gap = 3
    y0 = (map_size - side_len) // 2

    def columns(x0):
        cols = [[], []]
        for i, x in enumerate(range(x0, x0 + side_len, 2)):
            cols[i % 2] += [[x, y] for y in range(y0, y0 + side_len, 2)]
        return cols

    left = columns(map_size // 2 - gap - side_len)
    right = columns(map_size // 2 + gap)
    for h, pos in zip(handles, left + right):
        env.add_agents(h, method="custom", pos=pos)

def cli():
    return standard_cli("multi", n_round=2000, map_size=125)


def setup(args):
    """The env, its four handles, the four models and the runner of
    ``args``, in the JAX example's order; ``new_round()`` resets the map
    and places the armies."""
    env = magent.GridWorld(load_config(args.map_size), device=args.device)
    env.set_render_dir("build/render")
    handles = env.get_handles()

    RLModel, hyper = build_alg(args.alg, backend=args.backend)
    models = [
        magent.ProcessingModel(env, handles[i], f"{args.name}-{tag}",
                               20000 + i, 1000, RLModel, device=args.device,
                               **hyper)
        for i, tag in enumerate(("a0", "a1", "b0", "b1"))
    ]

    savedir = "save_model"
    start_from = load_checkpoints(models, savedir, args.load_from)

    print(args)
    runner = EpisodeRunner(
        env,
        [Side(h, m, train=args.train) for h, m in zip(handles, models)],
        max_steps=550, print_every=50, train_print_every=2000,
    )

    def new_round():
        env.reset()
        generate_map(env, args.map_size, handles)

    return SimpleNamespace(env=env, handles=handles, models=models,
                           runner=runner, new_round=new_round,
                           savedir=savedir, start_from=start_from)


def round_eps(args, k):
    return 0 if args.greedy else magent.utility.piecewise_decay(
        k, [0, 700, 1400], [1, 0.2, 0.05])


def main(argv=None):
    args = cli().parse_args(argv)
    magent.utility.init_logger(args.name)
    ex = setup(args)

    began = time.time()
    for k in range(ex.start_from, ex.start_from + args.n_round):
        tic = time.time()
        eps = round_eps(args, k)

        ex.new_round()
        loss, num, reward, value = ex.runner.play(
            eps, train=args.train,
            render=args.render or (k + 1) % args.render_every == 0)

        logging.info("round %d\t loss: %s\t num: %s\t reward: %s\t value: %s"
                     % (k, loss, num, reward, value))
        print(f"round {k} took {time.time() - tic:.2f}s "
              f"(total {time.time() - began:.2f}s)\n")

        if (k + 1) % args.save_every == 0 and args.train:
            save_checkpoints(ex.models, ex.savedir, k)

    for m in ex.models:
        m.quit()


if __name__ == "__main__":
    main()
