"""Train double-attack tigers: two tigers must strike one deer in the same
step to earn reward; deer wander randomly (port of
``examples/train_tiger.py``; capability parity with reference
examples/train_tiger.py).  From the repository root::

    python -m magent_tpu_torch.examples.train_tiger --train [--device cpu]
"""

import logging
import time
from types import SimpleNamespace

import magent_tpu_torch as magent
from magent_tpu_torch.builtin.rule_model import RandomActor
from magent_tpu_torch.examples.rollout import (EpisodeRunner, Side, build_alg,
                                               load_checkpoints,
                                               save_checkpoints, standard_cli)


def generate_map(env, map_size, handles):
    env.add_walls(method="random", n=map_size * map_size * 0.04)
    env.add_agents(handles[0], method="random", n=map_size * map_size * 0.05)
    env.add_agents(handles[1], method="random", n=map_size * map_size * 0.01)


def cli():
    return standard_cli("tiger", n_round=200, map_size=500)


def setup(args):
    """The env, its handles, the tigers' model, the deer and the runner of
    ``args``, in the JAX example's order; ``new_round()`` resets the map
    and places walls, deer and tigers."""
    env = magent.GridWorld("double_attack", map_size=args.map_size,
                           device=args.device)
    env.set_render_dir("build/render")
    handles = env.get_handles()

    # reference hyperparameters: DQN replay 2^20 flat transitions, DRQN
    # 20000 episode windows (reference examples/train_tiger.py:136,142)
    RLModel, hyper = build_alg(
        args.alg, backend=args.backend, target_update=500,
        memory_size=20000 if args.alg == "drqn" else 2 ** 20)
    model = RLModel(env, handles[1], args.name, device=args.device, **hyper)
    # a2c trains in-loop on accumulated transitions instead of per round
    step_batch = (int(10 * args.map_size * args.map_size * 0.01)
                  if args.alg == "a2c" else None)

    savedir = "save_model"
    start_from = load_checkpoints([model], savedir, args.load_from)

    deer = Side(handles[0], RandomActor(env, handles[0], "deer"),
                observe=False)
    tigers = Side(handles[1], model, train=args.train, buffer_capacity=10000)
    runner = EpisodeRunner(
        env, [deer, tigers], max_steps=1000, print_every=40,
        train_print_every=500, step_batch=step_batch,
    )

    print(args)

    def new_round():
        env.reset()
        generate_map(env, args.map_size, handles)

    return SimpleNamespace(env=env, handles=handles, models=[model],
                           runner=runner, new_round=new_round,
                           savedir=savedir, start_from=start_from)


def round_eps(args, k):
    return 0 if args.greedy else magent.utility.piecewise_decay(
        k, [0, 100, 200], [1, 0.1, 0.05])


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
            eps, train=args.train, render=args.render)

        logging.info("round %d\t loss: %s\t reward: %s\t value: %s"
                     % (k, loss[1], reward[1], value[1]))
        print(f"round {k} took {time.time() - tic:.2f}s "
              f"(total {time.time() - began:.2f}s)\n")

        if (k + 1) % args.save_every == 0 and args.train:
            save_checkpoints(ex.models, ex.savedir, k)


if __name__ == "__main__":
    main()
