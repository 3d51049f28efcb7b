"""Shared sample->train round loop of the port's train_* examples (port of
``examples/rollout.py``).

The reference repeats this loop in every example script
(reference: examples/train_battle.py:61-127 and siblings); here it is a
single runner parameterized by per-group :class:`Side` descriptors.  The
observable contract is preserved: e-greedy sampling per step, per-round (or
in-loop batched) training, and the ``round k\t key: value`` log line format
consumed by scripts/plot_*.py.

The port adds ``--device`` to :func:`standard_cli` (``None``: the card);
``--backend jax`` selects the port of the JAX model family
(``builtin.torch_model``), ``--backend torch`` the second backend
(``builtin.th_model``), so that the reference harness's command lines run
unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

import magent_tpu_torch as magent


@dataclass
class Side:
    """One trained or scripted group in the episode loop.

    ``managed`` models (ProcessingModel) buffer their own samples via
    ``sample_step``/``train``; unmanaged models get an explicit
    :class:`EpisodesBuffer` and a direct ``model.train(buffer)`` call.
    """

    handle: Any
    model: Any
    train: bool = False
    observe: bool = True  # scripted actors can skip real observations
    buffer_capacity: int = 0  # >0 -> unmanaged (external EpisodesBuffer)
    # transient per-step fields
    ids: Any = None
    obs: Any = None
    acts: Any = None
    buffer: Any = field(default=None, repr=False)

    def __post_init__(self):
        if self.buffer_capacity:
            self.buffer = magent.utility.EpisodesBuffer(self.buffer_capacity)


class EpisodeRunner:
    """Drives one environment episode across all sides, then trains.

    Parameters
    ----------
    env : magent.GridWorld
    sides : list[Side]
    max_steps : hard per-episode step cap (the reference examples each
        hard-code one: battle 550, pursuit 250, gather 350, tiger 1000)
    step_batch : if set, unmanaged training sides train in-loop every time
        this many transitions accumulate (reference train_tiger.py a2c mode)
    step_hook : optional ``f(runner, step, reward_arrays)`` receiving each
        side's per-agent reward array, for custom per-step metrics
        (e.g. gather's positive-reward counter)
    """

    def __init__(self, env, sides, *, max_steps, print_every=50,
                 step_batch=None, step_hook: Optional[Callable] = None,
                 train_print_every=1000):
        self.env = env
        self.sides = sides
        self.max_steps = max_steps
        self.print_every = print_every
        self.step_batch = step_batch
        self.step_hook = step_hook
        self.train_print_every = train_print_every
        self.nums = [0] * len(sides)
        self.step_ct = 0

    # ---------------------------------------------------------------- sample
    def sample(self, eps, render=False):
        """Run the episode until done (or the step cap).  Returns the
        per-side total rewards."""
        env = self.env
        sides = self.sides
        totals = np.zeros(len(sides))
        pending = 0  # transitions since the last in-loop train
        self.step_ct = 0

        self.nums = [env.get_num(s.handle) for s in sides]
        print(f"--- sampling (eps={eps:.2f}, nums={self.nums}) ---")
        began = time.time()

        # a hosted model has ONE pending-action slot, so the non-blocking
        # overlap is only sound for models driving a single side
        hosted_count = {}
        for s in sides:
            if hasattr(s.model, "fetch_action"):
                hosted_count[id(s.model)] = hosted_count.get(id(s.model), 0) + 1
            s.pending_sample = False

        def drain_sample(s):
            # collect a deferred sample ack before the next request's reply
            # (pipe replies arrive in command order)
            if s.pending_sample:
                s.model.check_done()
                s.pending_sample = False

        done = False
        while not done:
            # two-pass inference: kick off every hosted model non-blocking
            # (overlapping groups' inference like the reference's subprocess
            # loop), then fetch and commit actions
            for s in sides:
                s.ids = env.get_agent_id(s.handle)
                if s.observe:
                    s.obs = env.get_observation(s.handle)
                else:  # scripted actors ignore observations
                    k = len(s.ids)
                    s.obs = (np.empty(k), np.empty(k))
                if hosted_count.get(id(s.model), 0) == 1:
                    s.model.infer_action(s.obs, s.ids, 'e_greedy', eps,
                                         block=False)
                    s.acts = None
                else:
                    s.acts = s.model.infer_action(s.obs, s.ids, 'e_greedy',
                                                  eps)
            for s in sides:
                if s.acts is None:
                    drain_sample(s)
                    s.acts = s.model.fetch_action()
                env.set_action(s.handle, s.acts)

            done = env.step()

            per_step = []
            reward_arrays = []
            for idx, s in enumerate(sides):
                rewards = env.get_reward(s.handle)
                reward_arrays.append(rewards)
                if s.train:
                    alive = env.get_alive(s.handle)
                    if s.buffer is not None:
                        s.buffer.record_step(s.ids, s.obs, s.acts, rewards, alive)
                        pending += len(s.ids)
                    elif hosted_count.get(id(s.model), 0) == 1:
                        # overlap the worker's replay-buffer bookkeeping
                        # with the rest of this step (the point of hosting
                        # the model in a subprocess, model.py)
                        s.model.sample_step(rewards, alive, block=False)
                        s.pending_sample = True
                    else:
                        s.model.sample_step(rewards, alive)
                got = float(np.sum(rewards))
                totals[idx] += got
                per_step.append(got)

            if render:
                env.render()
            if self.step_hook is not None:
                self.step_hook(self, self.step_ct, reward_arrays)

            env.clear_dead()
            self.nums = [env.get_num(s.handle) for s in sides]

            if self.step_ct % self.print_every == 0:
                print(f"step {self.step_ct:3d}  nums={self.nums}  "
                      f"step_reward={np.around(per_step, 2).tolist()}  "
                      f"totals={np.around(totals, 2).tolist()}")
            self.step_ct += 1
            if self.step_ct > self.max_steps:
                break

            if (self.step_batch and pending > self.step_batch):
                for s in sides:
                    if s.train and s.buffer is not None:
                        self.in_loop_result = s.model.train(s.buffer, 500)
                        s.buffer.reset()
                pending = 0

        for s in sides:
            drain_sample(s)

        took = time.time() - began
        steps = max(self.step_ct, 1)
        print(f"sampled {self.step_ct} steps in {took:.2f}s "
              f"({took / steps:.3f}s/step)")
        return totals

    # ----------------------------------------------------------------- train
    def train(self):
        """Round-end training for every training side.  Returns
        (losses, values) lists aligned with sides."""
        losses = [0 for _ in self.sides]
        values = [0 for _ in self.sides]
        if not any(s.train for s in self.sides):
            return losses, values

        print("--- training ---")
        began = time.time()
        seen = {}  # self-play: sides sharing one model+buffer train once
        for idx, s in enumerate(self.sides):
            if not s.train:
                continue
            if s.buffer is not None:  # unmanaged: direct train on the buffer
                key = (id(s.model), id(s.buffer))
                if key in seen:
                    losses[idx], values[idx] = seen[key]
                    continue
                losses[idx], values[idx] = s.model.train(
                    s.buffer, print_every=self.train_print_every)
                seen[key] = (losses[idx], values[idx])
                s.buffer.reset()
            else:  # managed: kick off non-blocking
                s.model.train(print_every=self.train_print_every, block=False)
        for idx, s in enumerate(self.sides):
            if s.train and s.buffer is None:
                losses[idx], values[idx] = s.model.fetch_train()
        print(f"trained in {time.time() - began:.2f}s")
        return losses, values

    # ------------------------------------------------------------- one round
    def play(self, eps, render=False, train=True):
        """sample + (optionally) train; returns (loss, nums, reward, value)
        rounded for the log line."""
        was = [s.train for s in self.sides]
        if not train:
            for s in self.sides:
                s.train = False
        totals = self.sample(eps, render=render)
        losses, values = self.train()
        for s, w in zip(self.sides, was):
            s.train = w
        return (magent.round(losses), list(self.nums),
                magent.round(totals.tolist()), magent.round(values))


def standard_cli(name, *, n_round, map_size, save_every=5, algs=("dqn", "drqn", "a2c")):
    """The common argparse surface shared by every train_* example
    (reference flags: --train --render --map_size --n_round --alg
    --load_from --save_every --render_every --greedy --name --eval)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--save_every", type=int, default=save_every)
    p.add_argument("--render_every", type=int, default=10)
    p.add_argument("--n_round", type=int, default=n_round)
    p.add_argument("--render", action="store_true")
    p.add_argument("--load_from", type=int)
    p.add_argument("--train", action="store_true")
    p.add_argument("--map_size", type=int, default=map_size)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--name", type=str, default=name)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--backend", default="jax", choices=["jax", "torch"],
                   help="NN backend driving the models (the reference's "
                        "second-backend swap: tf_model <-> mx_model)")
    p.add_argument("--device", default=None,
                   help="torch device of the env and the models (default: "
                        "the GPU)")
    if algs:
        p.add_argument("--alg", default="dqn", choices=list(algs))
    return p


def model_module(backend="jax"):
    """Resolve a --backend choice to its model module (``jax``: the port
    of the JAX model family, ``builtin.torch_model``; ``torch``: the second
    backend, ``builtin.th_model``).  Capability parity
    with the reference's two-backend example suite, where the smoke harness
    sed-swaps ``tf_model`` -> ``mx_model`` and reruns every example
    (reference: scripts/test/test_examples.py:16-31)."""
    if backend == "jax":
        from magent_tpu_torch.builtin import torch_model
        return torch_model
    if backend == "torch":
        from magent_tpu_torch.builtin import th_model
        return th_model
    raise ValueError(f"unknown backend {backend!r} (expected jax or torch)")


def build_alg(alg, *, backend="jax", batch_size=256, unroll_step=8,
              target_update=1200, train_freq=5, memory_size=None,
              learning_rate=1e-4):
    """Map an --alg choice to (model class, constructor kwargs) with the
    conventional hyperparameters the examples share.  ``memory_size``
    defaults per algorithm (DQN 2^20 flat transitions; DRQN 8*625 episode
    windows, the battle example's sizing) — pass it explicitly where the
    original example used something else.  ``backend`` selects the model
    module (see :func:`model_module`); like the reference's MXNet backend,
    torch ships DQN and A2C but no DRQN."""
    mod = model_module(backend)

    if alg == "dqn":
        return mod.DeepQNetwork, dict(
            batch_size=batch_size, memory_size=memory_size or 2 ** 20,
            learning_rate=learning_rate, target_update=target_update,
            train_freq=train_freq)
    if alg == "drqn":
        if not hasattr(mod, "DeepRecurrentQNetwork"):
            raise ValueError(
                f"--alg drqn is not available on the {backend} backend "
                "(like the reference's mx_model, it ships dqn and a2c)")
        return mod.DeepRecurrentQNetwork, dict(
            batch_size=batch_size // unroll_step, unroll_step=unroll_step,
            memory_size=memory_size or 8 * 625, learning_rate=learning_rate,
            target_update=target_update, train_freq=train_freq)
    if alg == "a2c":
        return mod.AdvantageActorCritic, dict(
            batch_size=batch_size, learning_rate=10 * learning_rate)
    raise ValueError(alg)


def load_checkpoints(models, savedir, load_from):
    """Resume from epoch ``load_from`` (or return 0)."""
    if load_from is None:
        return 0
    print(f"resuming from epoch {load_from}")
    for m in models:
        m.load(savedir, load_from)
    return load_from


def save_checkpoints(models, savedir, epoch):
    print("checkpointing models")
    for m in models:
        m.save(savedir, epoch)
