"""Train pursuit: DQN predators chase DQN prey on the builtin pursuit game
(port of ``examples/train_pursuit.py``; capability parity with reference
examples/train_pursuit.py).  From the repository root::

    python -m magent_tpu_torch.examples.train_pursuit --train [--device cpu]
"""

import logging
import time
from types import SimpleNamespace

import magent_tpu_torch as magent
from magent_tpu_torch.examples.rollout import (EpisodeRunner, Side,
                                               load_checkpoints, model_module,
                                               save_checkpoints, standard_cli)


def generate_map(env, map_size, handles):
    """Random walls, then random predators and twice as many prey."""
    env.add_walls(method="random", n=map_size * map_size * 0.03)
    env.add_agents(handles[0], method="random", n=map_size * map_size * 0.0125)
    env.add_agents(handles[1], method="random", n=map_size * map_size * 0.025)


def cli():
    return standard_cli("pursuit", n_round=500, map_size=1000,
                        save_every=2, algs=None)


def setup(args):
    """The env, its handles, the two models and the runner of ``args``, in
    the JAX example's order; ``new_round()`` resets the map and places
    walls, predators and prey."""
    env = magent.GridWorld("pursuit", map_size=args.map_size,
                           device=args.device)
    env.set_render_dir("build/render")
    handles = env.get_handles()

    eval_obs = [None, None]
    if args.eval:
        print("building eval observation set")
        env.reset()
        generate_map(env, args.map_size, handles)
        eval_obs = magent.utility.sample_observation(env, handles, 2048, 500)

    DeepQNetwork = model_module(args.backend).DeepQNetwork
    models = [
        magent.ProcessingModel(env, handles[i], f"{args.name}-{tag}",
                               20001 + i, 1000, DeepQNetwork,
                               eval_obs=eval_obs[i], batch_size=512,
                               memory_size=2 ** 22, target_update=1000,
                               train_freq=4, device=args.device)
        for i, tag in enumerate(("predator", "prey"))
    ]

    savedir = "save_model"
    start_from = load_checkpoints(models, savedir, args.load_from)

    print(args)
    print("view_space", env.get_view_space(handles[0]))
    print("feature_space", env.get_feature_space(handles[0]))

    runner = EpisodeRunner(
        env,
        [Side(h, m, train=args.train) for h, m in zip(handles, models)],
        max_steps=250, print_every=50, train_print_every=2000,
    )

    def new_round():
        env.reset()
        generate_map(env, args.map_size, handles)

    return SimpleNamespace(env=env, handles=handles, models=models,
                           runner=runner, new_round=new_round,
                           savedir=savedir, start_from=start_from)


def round_eps(args, k):
    return 0 if args.greedy else magent.utility.piecewise_decay(
        k, [0, 200, 400], [1, 0.2, 0.05])


def main(argv=None):
    args = cli().parse_args(argv)
    magent.utility.init_logger(args.name)
    ex = setup(args)

    began = time.time()
    for k in range(ex.start_from, ex.start_from + args.n_round):
        tic = time.time()
        eps = round_eps(args, k)

        ex.new_round()
        loss, _, reward, value = ex.runner.play(
            eps, train=args.train,
            render=args.render or (k + 1) % args.render_every == 0)

        logging.info("round %d\t loss: %s\t reward: %s\t value: %s"
                     % (k, loss, reward, value))
        print(f"round {k} took {time.time() - tic:.2f}s "
              f"(total {time.time() - began:.2f}s)\n")

        if (k + 1) % args.save_every == 0 and args.train:
            save_checkpoints(ex.models, ex.savedir, k)

    for m in ex.models:
        m.quit()


if __name__ == "__main__":
    main()
