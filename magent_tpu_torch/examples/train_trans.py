"""Train two armies to fight across a walled map with door openings: the
transfer/curriculum variant of battle (port of ``examples/train_trans.py``;
capability parity with reference examples/train_trans.py: same agent
attributes, wall-with-doors geometry, and per-side reward rules).

Both models are hosted ProcessingModels; the episode loop is the shared
:class:`rollout.EpisodeRunner`.  From the repository root::

    python -m magent_tpu_torch.examples.train_trans --train [--device cpu]
"""

import logging
import math
import random
import time
from types import SimpleNamespace

import magent_tpu_torch as magent
from magent_tpu_torch.examples.rollout import (EpisodeRunner, Side, build_alg,
                                               load_checkpoints,
                                               save_checkpoints, standard_cli)


def get_config(map_size):
    gw = magent.gridworld
    cfg = gw.Config()
    cfg.set({"map_width": map_size, "map_height": map_size})
    cfg.set({"minimap_mode": True})
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


def generate_map(env, map_size, handles, n_doors=8, seed=0):
    """A vertical wall down the middle with ``n_doors`` two-cell openings;
    one army squared up on each side."""
    rng = random.Random(seed)
    mid = map_size // 2

    doors = set()
    while len(doors) < n_doors:
        y = rng.randrange(2, map_size - 4)
        doors.update((y, y + 1))
    env.add_walls(method="custom",
                  pos=[[mid, y] for y in range(1, map_size - 1)
                       if y not in doors])

    n_init = int(map_size * map_size * 0.03)
    side_len = int(math.sqrt(n_init)) * 2
    y0 = (map_size - side_len) // 2

    def square(x0):
        return [[x, y, 0]
                for x in range(x0, x0 + side_len, 2)
                for y in range(y0, y0 + side_len, 2)]

    env.add_agents(handles[0], method="custom", pos=square(mid - 4 - side_len))
    env.add_agents(handles[1], method="custom", pos=square(mid + 4))

def cli():
    return standard_cli("trans", n_round=2000, map_size=60)


def setup(args):
    """The env, its handles, the two models and the runner of ``args``,
    in the JAX example's order; ``new_round()`` resets the map, builds the
    wall and places the armies."""
    env = magent.GridWorld(get_config(args.map_size), device=args.device)
    env.set_render_dir("build/render")
    handles = env.get_handles()

    RLModel, hyper = build_alg(args.alg, backend=args.backend)
    models = [
        magent.ProcessingModel(env, handles[i], f"{args.name}-{tag}",
                               20000 + i, 1000, RLModel, device=args.device,
                               **hyper)
        for i, tag in enumerate(("l", "r"))
    ]

    savedir = "save_model"
    start_from = load_checkpoints(models, savedir, args.load_from)

    print(args)
    runner = EpisodeRunner(
        env,
        [Side(h, m, train=args.train) for h, m in zip(handles, models)],
        max_steps=500, print_every=50, train_print_every=1000,
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
