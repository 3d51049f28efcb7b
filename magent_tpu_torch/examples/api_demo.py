"""Minimal API walkthrough (port of ``examples/api_demo.py``; parity with
reference examples/api_demo.py): build a tiger-deer world, add walls and
agents, run random steps, dump replay frames.  From the repository root::

    python -m magent_tpu_torch.examples.api_demo [--device cpu]
"""

import argparse

import numpy as np

import magent_tpu_torch as magent


def run(device=None, map_size=100, max_steps=250, render_dir="build/render"):
    """The walk-through on ``device`` (``None``: the GPU) -> the steps
    taken."""
    env = magent.GridWorld("forest", map_size=map_size, device=device)
    env.set_render_dir(render_dir)

    deer_handle, tiger_handle = env.get_handles()

    env.reset()
    env.add_walls(method="random", n=map_size * map_size * 0.04)
    env.add_agents(deer_handle, method="random", n=5)
    env.add_agents(tiger_handle, method="random", n=2)

    v = env.get_view_space(tiger_handle)
    f = env.get_feature_space(tiger_handle)
    print("view space", v, "feature space", f)

    done = False
    step_ct = 0
    while not done:
        deer_obs = env.get_observation(deer_handle)  # noqa: F841
        tiger_obs = env.get_observation(tiger_handle)  # noqa: F841

        deer_act = np.random.randint(
            0, env.get_action_space(deer_handle)[0], env.get_num(deer_handle)
        ).astype(np.int32)
        tiger_act = np.random.randint(
            0, env.get_action_space(tiger_handle)[0], env.get_num(tiger_handle)
        ).astype(np.int32)
        env.set_action(deer_handle, deer_act)
        env.set_action(tiger_handle, tiger_act)

        done = env.step()

        env.render()
        deer_reward = env.get_reward(deer_handle)
        tiger_reward = env.get_reward(tiger_handle)
        env.clear_dead()

        print(
            "step: %d, deer: %d, tiger: %d, deer reward: %.2f, tiger reward: %.2f"
            % (
                step_ct,
                env.get_num(deer_handle),
                env.get_num(tiger_handle),
                deer_reward.sum(),
                tiger_reward.sum(),
            )
        )
        step_ct += 1
        if step_ct > max_steps:
            break
    return step_ct


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device of the world (default: the GPU)")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
