"""Self-play battle: ONE shared model plays both armies and learns from both
sides' experience (port of ``examples/train_single.py``; capability parity
with reference examples/train_single.py).  From the repository root::

    python -m magent_tpu_torch.examples.train_single --train [--device cpu]
"""

import logging
import math
import time
from types import SimpleNamespace

import magent_tpu_torch as magent
from magent_tpu_torch.examples.rollout import (EpisodeRunner, Side,
                                               load_checkpoints, model_module,
                                               save_checkpoints, standard_cli)


def generate_map(env, map_size, handles):
    """Two facing squares of agents."""
    n_init = int(map_size * map_size * 0.04)
    side_len = int(math.sqrt(n_init)) * 2
    gap = 3
    y0 = (map_size - side_len) // 2

    def square(x0):
        return [[x, y, 0]
                for x in range(x0, x0 + side_len, 2)
                for y in range(y0, y0 + side_len, 2)]

    env.add_agents(handles[0], method="custom",
                   pos=square(map_size // 2 - gap - side_len))
    env.add_agents(handles[1], method="custom",
                   pos=square(map_size // 2 + gap))


def cli():
    return standard_cli("battle", n_round=2000, map_size=125,
                        algs=("dqn", "drqn"))


def build_model(args, env, handle, eval_obs):
    """The shared model with the self-play hyperparameters."""
    mod = model_module(args.backend)
    if args.alg == "dqn":
        return mod.DeepQNetwork(env, handle, "selfplay", batch_size=512,
                                learning_rate=3e-4, memory_size=2 ** 21,
                                target_update=1200, train_freq=5,
                                eval_obs=eval_obs, device=args.device)
    if not hasattr(mod, "DeepRecurrentQNetwork"):
        raise ValueError(
            f"drqn is not available on the {args.backend} backend")
    return mod.DeepRecurrentQNetwork(env, handle, "selfplay",
                                     learning_rate=3e-4, batch_size=32,
                                     unroll_step=16,
                                     memory_size=2 * 8 * 625,
                                     target_update=1200, train_freq=5,
                                     eval_obs=eval_obs, device=args.device)


def setup(args):
    """The env, its handles, the shared model and the runner of ``args``,
    in the JAX example's order; ``new_round()`` resets the map and places
    the armies."""
    env = magent.GridWorld("battle", map_size=args.map_size,
                           device=args.device)
    env.set_render_dir("build/render")
    handles = env.get_handles()

    eval_obs = None
    if args.eval:
        print("building eval observation set")
        env.reset()
        generate_map(env, args.map_size, handles)
        eval_obs = magent.utility.sample_observation(env, handles, 2048, 500)[0]

    model = build_model(args, env, handles[0], eval_obs)

    savedir = "save_model"
    start_from = load_checkpoints([model], savedir, args.load_from)

    # both armies share the model AND the sample buffer: the runner trains
    # the (model, buffer) pair exactly once per round
    left = Side(handles[0], model, train=args.train, buffer_capacity=1000)
    right = Side(handles[1], model, train=args.train)
    right.buffer = left.buffer
    runner = EpisodeRunner(env, [left, right], max_steps=550, print_every=50)

    print(args)
    print("view_space", env.get_view_space(handles[0]))
    print("feature_space", env.get_feature_space(handles[0]))

    def new_round():
        env.reset()
        generate_map(env, args.map_size, handles)

    return SimpleNamespace(env=env, handles=handles, models=[model],
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
                     % (k, loss[0], num, reward, value[0]))
        print(f"round {k} took {time.time() - tic:.2f}s "
              f"(total {time.time() - began:.2f}s)\n")

        if (k + 1) % args.save_every == 0 and args.train:
            save_checkpoints(ex.models, ex.savedir, k)


if __name__ == "__main__":
    main()
