"""Train one army against a frozen opponent checkpoint on the battle game
(port of ``examples/train_against.py``; capability parity with reference
examples/train_against.py).

The left group plays a fixed DQN loaded from ``save_model`` (falling back to
an untrained net when no checkpoint exists); only the right group learns.
The episode loop is the shared :class:`rollout.EpisodeRunner` with an
unmanaged sample buffer for the learner.  From the repository root::

    python -m magent_tpu_torch.examples.train_against --train [--device cpu]
"""

import logging
import math
import time
from types import SimpleNamespace

import magent_tpu_torch as magent
from magent_tpu_torch.examples.rollout import (EpisodeRunner, Side,
                                               model_module, standard_cli)


def generate_map(env, map_size, handles):
    """Two facing squares, same geometry as train_battle."""
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


def build_learner(alg, env, handle, name, eval_obs, map_size, backend="jax",
                  device=None):
    """The learner uses the against-training hyperparameters (bigger replay
    and batch than the self-play examples)."""
    mod = model_module(backend)
    if alg == "dqn":
        return mod.DeepQNetwork(
            env, handle, name, eval_obs=eval_obs, batch_size=512,
            learning_rate=3e-4, memory_size=2 ** 21, target_update=1200,
            train_freq=5, device=device), None
    if alg == "drqn":
        if not hasattr(mod, "DeepRecurrentQNetwork"):
            raise ValueError(f"drqn is not available on the {backend} backend")
        return mod.DeepRecurrentQNetwork(
            env, handle, name, eval_obs=eval_obs, batch_size=512 // 16,
            unroll_step=16, learning_rate=3e-4, memory_size=2 * 8 * 625,
            target_update=1200, train_freq=5, device=device), None
    # a2c trains in-loop whenever enough fresh transitions accumulate
    model = mod.AdvantageActorCritic(
        env, handle, name, eval_obs=eval_obs, batch_size=512,
        learning_rate=1e-3, device=device)
    return model, int(10 * map_size * map_size * 0.04)


def cli():
    cli = standard_cli("against", n_round=2000, map_size=125, save_every=2)
    cli.add_argument("--opponent", type=int, default=0,
                     help="epoch of the frozen opponent checkpoint")
    cli.add_argument("--opponent_name", type=str, default="battle-l",
                     help="name of the frozen opponent model")
    return cli


def setup(args):
    """The env, its handles, the opponent, the learner and the runner of
    ``args``, in the JAX example's order; ``new_round()`` resets the map
    and places the armies."""
    env = magent.GridWorld("battle", map_size=args.map_size,
                           device=args.device)
    env.set_render_dir("build/render")
    handles = env.get_handles()

    eval_obs = None
    if args.eval:
        print("building eval observation set")
        env.reset()
        generate_map(env, args.map_size, handles)
        eval_obs = magent.utility.sample_observation(env, handles, 2048, 500)[1]

    opponent = model_module(args.backend).DeepQNetwork(
        env, handles[0], args.opponent_name, memory_size=2 ** 10,
        device=args.device)
    learner, step_batch = build_learner(args.alg, env, handles[1], args.name,
                                        eval_obs, args.map_size,
                                        backend=args.backend,
                                        device=args.device)

    savedir = "save_model"
    try:
        opponent.load(savedir, args.opponent)
        print(f"opponent = {args.opponent_name} @ epoch {args.opponent}")
    except FileNotFoundError:
        print("no opponent checkpoint found; opponent plays untrained")

    start_from = 0
    if args.load_from is not None:
        start_from = args.load_from
        print(f"resuming learner from epoch {start_from}")
        learner.load(savedir, start_from)

    print(args)
    runner = EpisodeRunner(
        env,
        [Side(handles[0], opponent, train=False),
         Side(handles[1], learner, train=args.train, buffer_capacity=5000)],
        max_steps=550, print_every=50, train_print_every=1000,
        step_batch=step_batch,
    )

    def new_round():
        env.reset()
        generate_map(env, args.map_size, handles)

    return SimpleNamespace(env=env, handles=handles,
                           models=[opponent, learner], learner=learner,
                           runner=runner, new_round=new_round,
                           savedir=savedir, start_from=start_from)


def round_eps(args, k):
    return 0 if args.greedy else magent.utility.piecewise_decay(
        k, [0, 400, 1000], [1, 0.2, 0.05])


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
            print("checkpointing learner")
            ex.learner.save(ex.savedir, k)


if __name__ == "__main__":
    main()
