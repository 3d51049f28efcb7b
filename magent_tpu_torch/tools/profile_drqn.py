"""Fused-DRQN cost ladder (port of ``scripts/profile_drqn.py``): the pieces
of ``parallel.train.make_drqn_train_step`` at the bench configuration
(battle 2x1000, B=16, rollout 8, BPTT window 8):

  env_only         rollout transitions, no nets (the env-loop floor)
  rollout          env + per-step GRU inference (epsilon-greedy acting)
  rollout_st       rollout, with the stored views and features read
  rollout+unr      rollout + BOTH BPTT unrolls (online + target), no grad
  loss_fwd         the window's TD loss forward on a fixed trajectory
  grad             the loss and its gradient on the fixed trajectory
  grad_remat       grad with the unrolls' steps checkpointed
  train_noopt      rollout + the gradient on its own window, no optimizer
  act_gradfix      rollout + the gradient on the fixed trajectory
  rand_grad        random-action rollout + the gradient on its window
  full             the complete train step (adds the optimizer)
  full_remat_dots  full with ``unroll_remat="dots"``
  full_remat_all   full with ``unroll_remat="all"``

Each variant runs ``--inner`` iterations per call, each from a fresh
subkey (``key, sk = split(key)``) on the call's operands, a warm-up call
and ``--calls`` timed calls from the same operands (the JAX script's
scanned program takes them as arguments), timed with CUDA events.  The
rollout is the train step's own (``train_step.rollout``, its nets under
``torch.no_grad``), the unrolls ``split_unroll``.  The loss variants use
the JAX script's own TD loss (``group_loss``): double-DQN targets from
the target nets, masked by the agents alive after each step, rewards
zeroed.  The fixed trajectory is the rollout from ``PRNGKey(7)`` with
rewards zeroed, and the variants on it move the window's initial state
by a draw in [1e-12, 2e-12) per iteration, as the JAX ones do to keep
their scan from hoisting the work.  A gradient is
``torch.autograd.grad`` over the group net's parameters, and its sink
the first 8 values of each parameter in flax's layout, in flax's order.
Nets are ``tools.bench_train.fresh_nets`` (``main`` takes others).

    python -m magent_tpu_torch.tools.profile_drqn [--rollout_len 8]
        [--dtype bf16] [--calls 4] [--inner 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy

import torch

from .. import random as rnd
from ..builtin.config import battle
from ..builtin.torch_model.drqn import split_unroll
from ..parallel import (ClipAdam, VecGridWorld, init_drqn_hiddens,
                        make_drqn_train_step, resolve_device)
from .bench_train import fresh_nets
from .timing import elapsed_ms

VARIANTS = ("env_only", "rollout", "rollout_st", "rollout+unr", "loss_fwd",
            "grad", "grad_remat", "train_noopt", "act_gradfix", "rand_grad",
            "full", "full_remat_dots", "full_remat_all")
GAMMA = 0.99  # group_loss's discount (profile_drqn.py:237)
EPS = 0.3  # the acting rollout's epsilon


def cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_per_group", type=int, default=1000)
    ap.add_argument("--map_size", type=int, default=200)
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--rollout_len", type=int, default=8)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--inner", type=int, default=4,
                    help="train steps fused per timed call")
    ap.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    ap.add_argument("--state_size", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    return ap


def grad_sink(net, grads):
    """``profile_drqn.py:264-265``: the sum of the first 8 values of each
    gradient in flax's layout (a dense kernel ``[in, out]``), in
    ``jax.tree.leaves``' order of the flax tree (keys sorted level by
    level)."""
    leaves = {}
    for (name, _), g in zip(net.named_parameters(), grads):
        *mods, leaf = name.split(".")
        if leaf == "weight":
            leaf, g = "kernel", (g.permute(2, 3, 1, 0) if g.dim() == 4
                                 else g.t())
        leaves[tuple(mods) + (leaf,)] = g
    return sum(leaves[k].reshape(-1)[:8].sum() for k in sorted(leaves))


def build(args, device, nets=None):
    """The variants at ``args``' geometry on ``device`` -> ({name: (fn,
    operands)}, agents per env step), ``fn(sk, *xs) -> (new xs, sink)``
    one iteration (``profile_drqn.py:84-378``)."""
    dt = {"f32": None, "bf16": torch.bfloat16}[args.dtype]
    venv = VecGridWorld(battle.get_config(args.map_size),
                        [args.n_per_group, args.n_per_group],
                        n_envs=args.n_envs, obs_dtype=dt, device=device)
    spec = venv.spec
    G, T = spec.n_groups, args.rollout_len
    if nets is None:
        nets = fresh_nets("drqn", spec, device, dt or torch.float32,
                          state_size=args.state_size)
    nets = tuple(nets)
    tx = ClipAdam(1e-4, 5.0)
    opt_states = tuple(tx.init(n) for n in nets)
    target_nets = tuple(copy.deepcopy(n) for n in nets)
    hiddens = init_drqn_hiddens(venv, nets)
    env_state = venv.reset(rnd.PRNGKey(1, device))
    step = make_drqn_train_step(venv, tx, rollout_len=T)
    acting = make_drqn_train_step(venv, tx, rollout_len=T,
                                  share_acting=False).rollout

    def group(t, g):
        """The slots of group ``g`` on the last axis of ``t``."""
        s = spec.groups[g]
        return t[..., s.offset:s.offset + s.cap]

    @torch.no_grad()
    def env_only(sk, state):
        r = []
        k = sk
        for _ in range(T):
            k, ak = rnd.split(k).unbind(-2)
            state, rew, alive, done = venv.transition(
                state, venv.random_actions(ak))
            r.append(rew[:, 0].sum())
        return (state,), torch.stack(r).sum()

    def rollout_only(sk, state, hid):
        state, hid, traj = acting(nets, state, hid, sk, EPS)
        return (state, hid), group(traj["actions"], 0)[..., ::64].sum()

    def rollout_store(sk, state, hid):
        state, hid, traj = acting(nets, state, hid, sk, EPS)
        s = group(traj["actions"], 0)[..., ::64].sum().float()
        for g in range(G):
            s = s + traj["views"][g][:, :, :, 0, 0, 0].float().sum()
            s = s + traj["feats"][g][:, :, :, 0].sum()
        return (state, hid), s

    def unroll_q(g, net, h0, traj, remat=False):
        views, feats = traj["views"][g], traj["feats"][g]
        keep = (group(traj["alive"], g)
                & ~traj["done"][:, :, None]).reshape(T, -1, 1)
        return split_unroll(net, views.reshape((T, -1) + views.shape[3:]),
                            feats.reshape(T, -1, feats.shape[-1]),
                            h0.reshape(-1, net.state_size), keep=keep,
                            remat=remat)

    @torch.no_grad()
    def rollout_unroll(sk, state, hid):
        h0 = hid
        state, hid, traj = acting(nets, state, hid, sk, EPS)
        s = 0.0
        for g in range(G):
            s = s + unroll_q(g, nets[g], h0[g], traj)[..., 0, 0].sum()
            s = s + unroll_q(g, target_nets[g], h0[g], traj)[..., 0, 0].sum()
        return (state, hid), s

    def group_loss(net, g, h0, traj, remat):
        """``profile_drqn.py:225-242``: the masked double-DQN TD loss of
        group ``g`` over the window from ``h0``."""
        B, cap = h0.shape[:2]
        act, rew = group(traj["actions"], g), group(traj["rewards"], g)
        alive, done_b = group(traj["alive"], g), traj["done"][:, :, None]
        qs = unroll_q(g, net, h0, traj, remat).reshape(T, B, cap, -1)
        with torch.no_grad():
            tqs = unroll_q(g, target_nets[g], h0, traj, remat).reshape(
                T, B, cap, -1)
        q_t = qs[:-1].gather(-1, act[:-1].long()[..., None])[..., 0]
        sel = qs[1:].detach().argmax(-1, keepdim=True)
        next_v = tqs[1:].gather(-1, sel)[..., 0]
        terminal = ~alive[:-1] | done_b[:-1]
        target = torch.where(terminal, rew[:-1], rew[:-1] + GAMMA * next_v)
        mask = alive[:-1].float()
        td = (target.detach() - q_t).square()
        return (td * mask).sum() / mask.sum().clamp_min(1.0)

    def loss_grad(net, g, h0, traj, remat=False):
        """(the loss, :func:`grad_sink` of its gradient)."""
        loss = group_loss(net, g, h0, traj, remat)
        grads = torch.autograd.grad(loss, list(net.parameters()))
        return loss.detach(), grad_sink(net, grads)

    def jitter(sk):
        return rnd.uniform(sk, (), 1e-12, 2e-12)

    def zero_rewards(traj):
        return dict(traj, rewards=torch.zeros_like(traj["rewards"]))

    with torch.no_grad():
        traj_fix = zero_rewards(acting(nets, env_state, hiddens,
                                       rnd.PRNGKey(7, device), EPS)[2])

    @torch.no_grad()
    def loss_fwd(sk, p, hid, traj):
        j = jitter(sk)
        s = sum(group_loss(p[g], g, hid[g] + j, traj, False)
                for g in range(G))
        return (p, hid, traj), s

    def grad_fn(remat):
        def fn(sk, p, hid, traj):
            j = jitter(sk)
            s = 0.0
            for g in range(G):
                loss, gs = loss_grad(p[g], g, hid[g] + j, traj, remat)
                s = s + loss + gs
            return (p, hid, traj), s
        return fn

    def train_noopt(sk, p, state, hid):
        h0 = hid
        state, hid, traj = acting(nets, state, hid, sk, EPS)
        traj = zero_rewards(traj)
        s = 0.0
        for g in range(G):
            loss, gs = loss_grad(p[g], g, h0[g], traj)
            s = s + loss + gs
        return (p, state, hid), s

    def act_gradfix(sk, p, state, hid, traj):
        state, hid2, live = acting(nets, state, hid, sk, EPS)
        j = jitter(sk)
        s = group(live["actions"], 0)[..., ::64].sum().float()
        for g in range(G):
            loss, gs = loss_grad(p[g], g, hiddens[g] + j, traj)
            s = s + loss + gs
        return (p, state, hid2, traj), s

    def rand_grad(sk, p, state, hid):
        steps, k = [], sk
        with torch.no_grad():
            for _ in range(T):
                k, ak = rnd.split(k).unbind(-2)
                obs = venv.observe_all(state)
                acts = venv.random_actions(ak)
                state, rew, alive, done = venv.transition(state, acts)
                steps.append((obs, acts, alive, done))
        traj = dict(
            views=[torch.stack([o[g][0] for o, *_ in steps])
                   for g in range(G)],
            feats=[torch.stack([o[g][1] for o, *_ in steps])
                   for g in range(G)],
            actions=torch.stack([r[1] for r in steps]),
            alive=torch.stack([r[2] for r in steps]),
            done=torch.stack([r[3] for r in steps]))
        traj["rewards"] = torch.zeros(traj["actions"].shape,
                                      device=device)
        s = 0.0
        for g in range(G):
            loss, gs = loss_grad(p[g], g, hid[g], traj)
            s = s + loss + gs
        return (p, state, hid), s

    def full_fn(train_step):
        def fn(sk, p, tp, opt, state, hid):
            p, opt, state, hid, metrics = train_step(p, tp, opt, state, hid,
                                                     sk, EPS)
            return (p, tp, opt, state, hid), metrics["loss"].sum()
        return fn

    full_ops = (nets, target_nets, opt_states, env_state, hiddens)
    variants = {
        "env_only": (env_only, (env_state,)),
        "rollout": (rollout_only, (env_state, hiddens)),
        "rollout_st": (rollout_store, (env_state, hiddens)),
        "rollout+unr": (rollout_unroll, (env_state, hiddens)),
        "loss_fwd": (loss_fwd, (nets, hiddens, traj_fix)),
        "grad": (grad_fn(False), (nets, hiddens, traj_fix)),
        "grad_remat": (grad_fn(True), (nets, hiddens, traj_fix)),
        "train_noopt": (train_noopt, (nets, env_state, hiddens)),
        "act_gradfix": (act_gradfix, (nets, env_state, hiddens, traj_fix)),
        "rand_grad": (rand_grad, (nets, env_state, hiddens)),
        "full": (full_fn(step), full_ops),
    }
    for mode in ("dots", "all"):
        variants["full_remat_" + mode] = (full_fn(make_drqn_train_step(
            venv, tx, rollout_len=T, unroll_remat=mode)), full_ops)
    return variants, 2 * args.n_per_group * args.n_envs


def main(argv=None, nets=None):
    """-> {variant: (ms per env step, the warm-up call's sink)}."""
    args = cli().parse_args(argv)
    device = resolve_device(args.device)
    variants, total_agents = build(args, device, nets)
    T = args.rollout_len

    def timed(name, fn, fargs):
        """``fn(sk, *xs) -> (new xs, sink)`` over ``--inner`` iterations
        per call; every call starts from a copy of ``fargs``."""
        def run(key, xs):
            sinks = []
            for _ in range(args.inner):
                key, sk = rnd.split(key).unbind(-2)
                xs, s = fn(sk, *xs)
                sinks.append(s)
            return torch.stack(sinks).sum()

        warm = float(run(rnd.PRNGKey(2, device), copy.deepcopy(fargs)))
        operands = [copy.deepcopy(fargs) for _ in range(args.calls)]
        c = iter(range(args.calls))

        def call():
            i = next(c)
            run(rnd.fold_in(rnd.PRNGKey(3, device), i), operands[i])

        ms = elapsed_ms(call, args.calls, device) / (
            args.calls * args.inner * T)
        print("%-15s %8.3f ms/env-step  %7.2fM trained agent-steps/s"
              % (name, ms, total_agents / ms / 1e3), flush=True)
        return ms, warm

    return {name: timed(name, fn, fargs)
            for name, (fn, fargs) in variants.items()}


if __name__ == "__main__":
    main()
