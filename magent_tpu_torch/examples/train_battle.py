"""Train battle: two parameter-sharing DQN armies on the builtin battle game
(port of ``examples/train_battle.py``; capability parity with reference
examples/train_battle.py).

Both models live in-process; PyTorch's asynchronous launches overlap their
inference on the card (the reference needed one subprocess per group).  The
episode loop is the shared :class:`rollout.EpisodeRunner`.  From the
repository root::

    python -m magent_tpu_torch.examples.train_battle --train [--device cpu]
"""

import logging
import math
import time
from types import SimpleNamespace

import magent_tpu_torch as magent
from magent_tpu_torch.examples.rollout import (EpisodeRunner, Side, build_alg,
                                               load_checkpoints,
                                               save_checkpoints, standard_cli)

# armies alternate sides of the map every round
_flip = [False]


def generate_map(env, map_size, handles):
    """Two facing squares of agents, mirrored each round."""
    n_init = int(map_size * map_size * 0.04)
    side_len = int(math.sqrt(n_init)) * 2
    gap = 3
    y0 = (map_size - side_len) // 2

    def square(x0):
        return [[x, y, 0]
                for x in range(x0, x0 + side_len, 2)
                for y in range(y0, y0 + side_len, 2)]

    left = square(map_size // 2 - gap - side_len)
    right = square(map_size // 2 + gap)
    _flip[0] = not _flip[0]
    first, second = (right, left) if _flip[0] else (left, right)
    env.add_agents(handles[0], method="custom", pos=first)
    env.add_agents(handles[1], method="custom", pos=second)


def cli():
    return standard_cli("battle", n_round=2000, map_size=125)


def setup(args):
    """The env, its handles, the two models and the runner of ``args``, in
    the JAX example's order; ``new_round()`` resets the map and places the
    armies."""
    env = magent.GridWorld("battle", map_size=args.map_size,
                           device=args.device)
    env.set_render_dir("build/render")
    handles = env.get_handles()

    eval_obs = [None, None]
    if args.eval:
        print("building eval observation set")
        env.reset()
        generate_map(env, args.map_size, handles)
        eval_obs = magent.utility.sample_observation(env, handles, 2048, 500)

    RLModel, hyper = build_alg(args.alg, backend=args.backend)
    models = [
        magent.ProcessingModel(env, handles[i], f"{args.name}-{tag}",
                               20000 + i, 1000, RLModel,
                               eval_obs=eval_obs[i], device=args.device,
                               **hyper)
        for i, tag in enumerate(("l", "r"))
    ]

    savedir = "save_model"
    start_from = load_checkpoints(models, savedir, args.load_from)

    print(args)
    print("view_space", env.get_view_space(handles[0]))
    print("feature_space", env.get_feature_space(handles[0]))

    runner = EpisodeRunner(
        env,
        [Side(h, m, train=args.train) for h, m in zip(handles, models)],
        max_steps=550, print_every=50, train_print_every=1000,
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
