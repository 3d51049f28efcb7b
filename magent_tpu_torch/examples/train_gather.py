"""Train gather: DQN agents race to eat high-hp static food, with minimap
navigation and attack shaping (port of ``examples/train_gather.py``;
capability parity with reference examples/train_gather.py).  From the
repository root::

    python -m magent_tpu_torch.examples.train_gather --train [--device cpu]
"""

import logging
import time
from types import SimpleNamespace

import magent_tpu_torch as magent
from magent_tpu_torch.examples.rollout import (EpisodeRunner, Side,
                                               load_checkpoints, model_module,
                                               save_checkpoints, standard_cli)


def load_config(size):
    gw = magent.gridworld
    cfg = gw.Config()

    cfg.set({"map_width": size, "map_height": size})
    cfg.set({"minimap_mode": True})

    agent = cfg.register_agent_type(
        name="agent",
        attr={'width': 1, 'length': 1, 'hp': 3, 'speed': 3,
              'view_range': gw.CircleRange(7), 'attack_range': gw.CircleRange(1),
              'damage': 6, 'step_recover': 0,
              'step_reward': -0.01, 'dead_penalty': -1, 'attack_penalty': -0.1,
              'attack_in_group': 1})

    food = cfg.register_agent_type(
        name='food',
        attr={'width': 1, 'length': 1, 'hp': 25, 'speed': 0,
              'view_range': gw.CircleRange(1), 'attack_range': gw.CircleRange(0),
              'kill_reward': 5})

    g_f = cfg.add_group(food)
    g_s = cfg.add_group(agent)

    a = gw.AgentSymbol(g_s, index='any')
    b = gw.AgentSymbol(g_f, index='any')

    cfg.add_reward_rule(gw.Event(a, 'attack', b), receiver=a, value=0.5)

    return cfg


def generate_map(env, map_size, food_handle, player_handle):
    """Agents ring the rim; food rings concentrate toward the center."""
    cx = cy = map_size // 2

    def ring(out, frac, gap):
        half = int(map_size * frac) // 2
        for x in range(cx - half, cx + half + 1, gap):
            out += [[x, cy - half], [x, cy + half]]
        for y in range(cy - half, cy + half + 1, gap):
            out += [[cx - half, y], [cx + half, y]]

    players = []
    for frac, gap in [(0.9, 3), (0.8, 4), (0.7, 6)]:
        ring(players, frac, gap)
    env.add_agents(player_handle, method="custom", pos=players)

    food = []
    for frac, gap in [(0.65, 10), (0.6, 10), (0.55, 10), (0.5, 4),
                      (0.45, 3), (0.4, 1), (0.3, 1)]:
        ring(food, frac, gap)
    for shrink in (2, 4, 6):
        half_frac = (map_size * 0.3 - shrink) / map_size
        ring(food, half_frac, 1)
    env.add_agents(food_handle, method="custom", pos=food)


def cli():
    cli = standard_cli("gather", n_round=1500, map_size=200,
                       save_every=2, algs=None)
    cli.add_argument("--print_every", type=int, default=100)
    cli.add_argument("--record", action="store_true")
    return cli


def setup(args):
    """The env, its handles, the model and the runner of ``args``, in the
    JAX example's order; ``new_round()`` clears the positive-reward
    counter (``rewarded``), resets the map and places agents and food."""
    env = magent.GridWorld(load_config(size=args.map_size),
                           device=args.device)
    env.set_render_dir("build/render")
    food_handle, player_handle = env.get_handles()

    eval_obs = None
    if args.eval:
        print("building eval observation set")
        env.reset()
        generate_map(env, args.map_size, food_handle, player_handle)
        eval_obs = magent.utility.sample_observation(
            env, [player_handle], 2048, 500)[0]

    DeepQNetwork = model_module(args.backend).DeepQNetwork
    model = DeepQNetwork(env, player_handle, args.name,
                         batch_size=512, memory_size=2 ** 19,
                         target_update=1000, train_freq=4, eval_obs=eval_obs,
                         device=args.device)

    savedir = "save_model"
    start_from = load_checkpoints([model], savedir, args.load_from)

    print(args)
    print("view_space", env.get_view_space(player_handle))

    # count distinct agents that ever earned a positive reward this episode
    rewarded = set()

    def track_positive(runner, step, reward_arrays):
        side = runner.sides[0]
        for agent_id, r in zip(side.ids, reward_arrays[0]):
            if r > 0.05:
                rewarded.add(int(agent_id))

    runner = EpisodeRunner(
        env,
        [Side(player_handle, model, train=args.train, buffer_capacity=5000)],
        max_steps=350, print_every=args.print_every,
        train_print_every=250, step_hook=track_positive,
    )

    def new_round():
        rewarded.clear()
        env.reset()
        generate_map(env, args.map_size, food_handle, player_handle)

    return SimpleNamespace(env=env, handles=[food_handle, player_handle],
                           models=[model], runner=runner, rewarded=rewarded,
                           new_round=new_round, savedir=savedir,
                           start_from=start_from)


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

        logging.info(
            "round %d\t loss: %s\t reward: %s\t value: %s\t pos_reward_ct: %s"
            % (k, loss[0], reward[0], value[0], len(ex.rewarded)))
        print(f"round {k} took {time.time() - tic:.2f}s "
              f"(total {time.time() - began:.2f}s)\n")

        if args.record:
            with open("reward-hunger.txt", "a") as fout:
                fout.write(str(num[0]) + "\n")

        if (k + 1) % args.save_every == 0 and args.train:
            save_checkpoints(ex.models, ex.savedir, k)


if __name__ == "__main__":
    main()
