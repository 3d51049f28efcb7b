"""Battle training on the port's fused path: env stepping, observation
rendering, policy inference and the learner's update run over a batch of
lockstep envs on the card, with no NumPy round trip inside a round (port
of ``examples/train_battle_fused.py``).

This is the throughput-oriented counterpart of :mod:`.train_battle` (which
mirrors the reference's host-driven loop): transitions never leave device
memory.  The trainers are ``parallel.train``'s
``make_{dqn,dqn_remat,a2c,drqn}_train_loop`` and ``make_eval_q``, the
optimizer ``parallel.optim.ClipAdam`` (optax's ``clip_by_global_norm(5)``
then Adam).  The env batch, the nets, the target nets and the optimizer
states are placed on ``make_mesh()``'s mesh as the JAX example places them
(``parallel.sharding``): alone the run is a one-rank mesh on one device;
started as ranks of a ``torch.distributed`` group (``init_process_group``
before ``main``) each rank steps its slice of the envs and rank 0 alone
prints and saves.  From the repository root::

    python -m magent_tpu_torch.examples.train_battle_fused [--alg a2c]
        [--device cpu]
"""

import argparse
import copy
import logging as log
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

import magent_tpu_torch as magent
from magent_tpu_torch import random as rnd
from magent_tpu_torch.builtin.config import battle
from magent_tpu_torch.builtin.torch_model import (A2CNet, DQNNet, DRQNNet,
                                                  tensors_to_flax)
from magent_tpu_torch.builtin.torch_model.flax_params import init_dense_
from magent_tpu_torch.parallel import (ClipAdam, VecGridWorld, device_put,
                                       gather, init_drqn_hiddens,
                                       make_a2c_train_loop,
                                       make_dqn_remat_train_loop,
                                       make_dqn_train_loop,
                                       make_drqn_train_loop, make_eval_q,
                                       make_mesh, param_sharding,
                                       sample_eval_set)

SUBCLASS = {"dqn": "tfdqn", "dqn_remat": "tfdqn", "drqn": "tfdrqn",
            "a2c": "tfa2c"}


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_round", type=int, default=200,
                        help="train-step calls (each = rollout_len env steps)")
    parser.add_argument("--alg", default="dqn", choices=["dqn", "dqn_remat", "drqn", "a2c"])
    parser.add_argument("--map_size", type=int, default=64)
    parser.add_argument("--agents_per_side", type=int, default=64)
    parser.add_argument("--n_envs", type=int, default=16)
    parser.add_argument("--rollout_len", type=int, default=8)
    parser.add_argument("--train_minibatch", type=int, default=16384,
                        help="sampled transitions per gradient step "
                             "(0 = train on the full rollout; dqn only)")
    parser.add_argument("--target_update", type=int, default=40)
    parser.add_argument("--steps_per_call", type=int, default=10,
                        help="train steps per loop call")
    parser.add_argument("--name", type=str, default="battle-fused")
    parser.add_argument("--save_every", type=int, default=0,
                        help="checkpoint both groups every N rounds "
                             "(tfdqn_<round>.npz generations, the inputs "
                             "to scripts/tournament.py)")
    parser.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                        help="obs + net-trunk compute dtype (bf16 = the "
                             "bench configuration; params stay f32)")
    parser.add_argument("--eval_q_every", type=int, default=0,
                        help="log group-0 mean max-Q (online AND target "
                             "net) on a fixed eval observation set every N "
                             "rounds — the reference's eval-Q methodology "
                             "(utility.py:115-178, dqn.py:348-356); dqn "
                             "algs only")
    parser.add_argument("--device", default=None,
                        help="torch device of every rank's envs and nets "
                             "(default: the rank's GPU)")
    return parser


def fresh_net(alg, spec, g, dtype):
    """Group ``g``'s net, flax's initializers drawn from a torch generator
    seeded ``g``.  The JAX example draws them from ``fold_in(PRNGKey(0),
    g)``, so the two start from other weights; from the same weights
    (carried with ``params_from_flax``) one loop call agrees."""
    vs, fs, na = (spec.view_space(g), spec.feature_size(g),
                  spec.groups[g].type.n_action)
    gen = torch.Generator().manual_seed(g)
    if alg == "a2c":
        return A2CNet(vs, fs, na, dtype=dtype, generator=gen)
    if alg == "drqn":
        return DRQNNet(vs, fs, na, dtype=dtype, generator=gen)
    net = DQNNet(vs, fs, na, dtype=dtype)
    init_dense_(net, gen)
    return net


def setup(args):
    """The envs, nets, optimizer states and train loop of ``args``, in the
    JAX example's order -> a namespace whose ``carry`` is the loop's state
    (``call(c, eps)`` runs loop call ``c``) and whose ``placement`` is the
    nets' ``param_sharding`` (what ``gather`` of an optimizer state
    takes)."""
    dt = {"f32": None, "bf16": torch.bfloat16}[args.dtype]
    mesh = make_mesh(devices=args.device)
    # the envs' dp placement (JAX: device_put(env_state, state_sharding)):
    # the venv holds this rank's rows and resets only those
    venv = VecGridWorld(battle.get_config(args.map_size),
                        [args.agents_per_side, args.agents_per_side],
                        n_envs=args.n_envs, obs_dtype=dt, mesh=mesh)
    spec = venv.spec
    dev = venv.device
    nets = tuple(fresh_net(args.alg, spec, g, dt or torch.float32).to(dev)
                 for g in range(spec.n_groups))
    lr = 1e-3 if args.alg == "a2c" else 1e-4
    tx = ClipAdam(lr, 5.0)
    opt_states = tuple(tx.init(n) for n in nets)
    target_nets = tuple(copy.deepcopy(n).requires_grad_(False)
                        for n in nets)
    placement = param_sharding(mesh, nets)
    nets = device_put(nets, placement)
    target_nets = device_put(target_nets, placement)
    opt_states = device_put(opt_states, placement)

    common = dict(steps_per_call=args.steps_per_call,
                  rollout_len=args.rollout_len)
    if args.alg == "dqn":
        loop = make_dqn_train_loop(
            venv, tx, target_update=args.target_update,
            train_minibatch=args.train_minibatch or None, **common)
    elif args.alg == "dqn_remat":
        # the headline trainer (RESULTS.md): stores compact states, re-renders
        # observations inside the loss instead of carrying them
        loop = make_dqn_remat_train_loop(
            venv, tx, target_update=args.target_update, **common)
    elif args.alg == "drqn":
        loop = make_drqn_train_loop(
            venv, tx, target_update=args.target_update, **common)
    else:
        loop = make_a2c_train_loop(venv, tx, **common)

    env_state = venv.reset(rnd.PRNGKey(1, dev))
    if args.alg == "a2c":
        carry = [nets, opt_states, env_state]
    elif args.alg == "drqn":
        carry = [nets, target_nets, opt_states, env_state,
                 init_drqn_hiddens(venv, nets)]
    else:
        carry = [nets, target_nets, opt_states, env_state]
    step_key = rnd.PRNGKey(2, dev)

    def call(c, eps):
        """Loop call ``c`` at ``eps`` on ``carry`` (in place) -> metrics."""
        ck = rnd.fold_in(step_key, c)
        if args.alg == "a2c":
            out = loop(*carry, ck)
        else:
            out = loop(*carry, ck, eps, c * args.steps_per_call)
        carry[:] = out[:-1]
        return out[-1]

    return SimpleNamespace(venv=venv, mesh=mesh, placement=placement, tx=tx,
                           loop=loop, carry=carry, call=call)


def _quiet(*args, **kwargs):
    pass


def main(argv=None):
    args = cli().parse_args(argv)

    ex = setup(args)
    venv = ex.venv
    lead = ex.mesh.rank == 0  # rank 0 alone logs, prints and saves
    if lead:
        magent.utility.init_logger(args.name)
    say = print if lead else _quiet
    info = log.info if lead else _quiet

    def save(epoch):
        for g, suffix in enumerate(["l", "r"]):
            flat = tensors_to_flax(gather(ex.carry[0][g]))  # every rank
            if not lead:
                continue
            savedir = os.path.join("save_model",
                                   "%s-%s" % (args.name, suffix))
            os.makedirs(savedir, exist_ok=True)
            path = os.path.join(savedir,
                                "%s_%d.npz" % (SUBCLASS[args.alg], epoch))
            np.savez(path, **flat)
        say("saved generation", epoch)

    say("alg:", args.alg, " device:", venv.device,
          " envs:", args.n_envs, " agents/env:", 2 * args.agents_per_side)
    if args.save_every and args.save_every % args.steps_per_call:
        # saves fire on call boundaries; align rather than silently skip
        args.save_every = -(-args.save_every
                            // args.steps_per_call) * args.steps_per_call
        say("save_every rounded up to %d (steps_per_call boundary)"
              % args.save_every)
    if args.save_every:
        save(0)  # the untrained generation anchors the tournament
    evq = ev_views = ev_feats = None
    if args.eval_q_every and args.alg in ("dqn", "dqn_remat"):
        if args.eval_q_every % args.steps_per_call:
            args.eval_q_every = -(-args.eval_q_every
                                  // args.steps_per_call) * args.steps_per_call
            say("eval_q_every rounded up to %d" % args.eval_q_every)
        ev_views, ev_feats = sample_eval_set(venv, 0)
        evq = make_eval_q(venv, 0)
    start = time.time()
    env_steps = 0
    n_calls = -(-args.n_round // args.steps_per_call)
    for c in range(n_calls):
        k = c * args.steps_per_call
        eps = magent.utility.piecewise_decay(
            k, [0, args.n_round // 3, args.n_round], [1, 0.2, 0.05])
        metrics = ex.call(c, eps)
        env_steps += args.rollout_len * args.n_envs * args.steps_per_call
        if (args.save_every
                and (k + args.steps_per_call) % args.save_every == 0):
            save(k + args.steps_per_call)
        if evq is not None and (k + args.steps_per_call) % args.eval_q_every == 0:
            q_on = float(evq(ex.carry[0], ev_views, ev_feats))
            q_tg = float(evq(ex.carry[1], ev_views, ev_feats))
            info("round %d\t evalq: %.4f\t targetq: %.4f"
                     % (k + args.steps_per_call, q_on, q_tg))
        if c % 2 == 0 or c == n_calls - 1:
            loss = metrics["loss"][-1].cpu().numpy()
            rew = metrics["mean_reward"][-1].cpu().numpy()
            dt = time.time() - start
            info("round %d\t loss: %s\t reward: %s\t env_steps/s: %.1f"
                     % (k, np.round(loss, 4).tolist(),
                        np.round(rew, 4).tolist(), env_steps / dt))

    dt = time.time() - start
    total_agents = 2 * args.agents_per_side
    say("trained %d env-steps (%.1fM agent-steps) in %.1fs -> %.1f "
          "agent-steps/s" % (env_steps, env_steps * total_agents / 1e6, dt,
                             env_steps * total_agents / dt))

    # final checkpoint, compatible with the hosted model loaders (labelled
    # with the ROUNDS ACTUALLY TRAINED — n_calls * steps_per_call — and
    # skipped when the in-loop save already wrote that generation)
    trained = n_calls * args.steps_per_call
    if not args.save_every:
        save(0)
    elif trained % args.save_every:
        save(trained)


if __name__ == "__main__":
    main()
