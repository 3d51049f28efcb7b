"""Train agents to arrange themselves into a message: goal markers (a
can_absorb agent type) spell text from the 8x8 pixel font; agents get
reward for colliding into (being absorbed by) an unfilled marker (port of
``examples/train_arrange.py``; parity with reference
examples/train_arrange.py).  From the repository root::

    python -m magent_tpu_torch.examples.train_arrange --train [--device cpu]
"""

import argparse
import logging as log
import os
import time
from types import SimpleNamespace

import numpy as np

import magent_tpu_torch as magent
from magent_tpu_torch.examples.rollout import model_module
from magent_tpu_torch.renderer.server.arrange_server import (generate_map,
                                                             load_config)
from magent_tpu_torch.utility import FontProvider

FONT_FILE = os.path.join(os.path.dirname(__file__), "..", "..", "data",
                         "font_8x8", "basic.txt")


def play_a_round(env, map_size, font, messages, handles, model,
                 print_every=50, train=True, render=False, eps=None,
                 max_steps=350):
    env.reset()
    generate_map(env, map_size, handles[0], handles[1], messages, font)

    step_ct = 0
    done = False
    total_reward = 0.0
    goal_handle, agent_handle = handles
    sample_buffer = magent.utility.EpisodesBuffer(capacity=5000)

    print("===== sample =====")
    print("eps %.2f  goals %d  agents %d" %
          (eps, env.get_num(goal_handle), env.get_num(agent_handle)))
    start_time = time.time()
    while not done:
        obs = env.get_observation(agent_handle)
        ids = env.get_agent_id(agent_handle)
        acts = model.infer_action(obs, ids, 'e_greedy', eps)
        env.set_action(agent_handle, acts)
        env.set_action(goal_handle,
                       np.zeros(env.get_num(goal_handle), np.int32))

        done = env.step()

        rewards = env.get_reward(agent_handle)
        if train:
            sample_buffer.record_step(ids, obs, acts, rewards,
                                      env.get_alive(agent_handle))
        total_reward += sum(rewards)

        if render:
            env.render()
        env.clear_dead()

        sl = env._group_slice(goal_handle)
        filled = int(np.sum(env.state.absorbed[0, sl].cpu().numpy()))
        if step_ct % print_every == 0:
            print("step %3d,  filled %d,  reward %.2f" %
                  (step_ct, filled, total_reward))
        step_ct += 1
        if step_ct > max_steps or env.get_num(agent_handle) == 0:
            break

    print("steps: %d, time %.2f" % (step_ct, time.time() - start_time))

    total_loss = value = 0
    if train:
        total_loss, value = model.train(sample_buffer, print_every=500)

    return (magent.round(total_loss), magent.round(total_reward),
            magent.round(value), filled)


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--save_every", type=int, default=5)
    parser.add_argument("--n_round", type=int, default=1000)
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--load_from", type=int)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--map_size", type=int, default=100)
    parser.add_argument("--greedy", action="store_true")
    parser.add_argument("--name", type=str, default="arrange")
    parser.add_argument("--message", type=str, default="MAGENT")
    parser.add_argument("--backend", default="jax",
                        choices=["jax", "torch"])
    parser.add_argument("--device", default=None,
                        help="torch device of the env and the model "
                             "(default: the GPU)")
    return parser


def setup(args):
    """The env, its handles, the font and the model of ``args``, in the JAX
    example's order (each round's reset and map are
    :func:`play_a_round`'s)."""
    env = magent.GridWorld(load_config(args.map_size), device=args.device)
    env.set_render_dir("build/render")
    handles = env.get_handles()
    font = FontProvider(FONT_FILE)

    RLModel = model_module(args.backend).DeepQNetwork
    model = RLModel(env, handles[1], args.name, batch_size=256,
                    memory_size=2 ** 19, target_update=1000, train_freq=4,
                    device=args.device)

    savedir = 'save_model'
    start_from = args.load_from or 0
    if args.load_from is not None:
        model.load(savedir, start_from)

    print(args)
    return SimpleNamespace(env=env, handles=handles, font=font, model=model,
                           models=[model], savedir=savedir,
                           start_from=start_from)


def round_eps(args, k):
    return magent.utility.piecewise_decay(k, [0, 400, 800], [1, 0.2, 0.08]) \
        if not args.greedy else 0


def main(argv=None):
    args = cli().parse_args(argv)

    magent.utility.init_logger(args.name)
    ex = setup(args)

    start = time.time()
    for k in range(ex.start_from, ex.start_from + args.n_round):
        tic = time.time()
        eps = round_eps(args, k)
        loss, reward, value, filled = play_a_round(
            ex.env, args.map_size, ex.font, [args.message], ex.handles,
            ex.model, train=args.train, render=args.render, eps=eps)
        log.info("round %d\t loss: %s\t reward: %s\t value: %s\t filled: %s"
                 % (k, loss, reward, value, filled))
        print("round time %.2f  total time %.2f\n" %
              (time.time() - tic, time.time() - start))
        if (k + 1) % args.save_every == 0 and args.train:
            ex.model.save(ex.savedir, k)


if __name__ == "__main__":
    main()
