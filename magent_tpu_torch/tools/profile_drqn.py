"""Fused-DRQN cost ladder (port of ``scripts/profile_drqn.py``): the pieces
of ``parallel.train.make_drqn_train_step`` at the bench configuration
(battle 2x1000, B=16, rollout 8, BPTT window 8):

  env_only      rollout transitions, no nets (the env-loop floor)
  rollout       env + per-step GRU inference (epsilon-greedy acting)
  rollout+unr   rollout + BOTH BPTT unrolls (online + target), no grad
  full          the complete train step (adds backward + adam)

Each variant runs ``--inner`` iterations per call, each from a fresh
subkey (``key, sk = split(key)``) on the call's operands, a warm-up call
and ``--calls`` timed calls from the same operands (the JAX script's
scanned program takes them as arguments), timed with CUDA events.  The
rollout is the train step's own (``train_step.rollout``, its nets under
``torch.no_grad``), the unrolls ``split_unroll``.  The JAX script's finer
variants (``rollout_st``, ``loss_fwd``, ``grad``, ``grad_remat``,
``train_noopt``, ``act_gradfix``, ``rand_grad``, ``full_remat_*``)
isolate pieces of its XLA program and are not ported.  Nets are
``tools.bench_train.fresh_nets`` (``main`` takes others).

    python -m magent_tpu_torch.tools.profile_drqn [--rollout_len 8]
        [--dtype bf16] [--device cpu]
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

VARIANTS = ("env_only", "rollout", "rollout+unr", "full")


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


def main(argv=None, nets=None):
    """-> {variant: (ms per env step, the warm-up call's sink)}."""
    args = cli().parse_args(argv)
    device = resolve_device(args.device)
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
    total_agents = 2 * args.n_per_group * args.n_envs
    cap0, off0 = spec.groups[0].cap, spec.groups[0].offset

    def timed(name, fn, *fargs):
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
        print("%-13s %8.3f ms/env-step  %7.2fM trained agent-steps/s"
              % (name, ms, total_agents / ms / 1e3), flush=True)
        return ms, warm

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
        state, hid, traj = acting(nets, state, hid, sk, 0.3)
        return (state, hid), traj["actions"][:, :, off0:off0 + cap0][
            ..., ::64].sum()

    def unroll_q(g, net, h0, traj):
        views, feats = traj["views"][g], traj["feats"][g]
        s = spec.groups[g]
        keep = (traj["alive"][:, :, s.offset:s.offset + s.cap]
                & ~traj["done"][:, :, None]).reshape(T, -1, 1)
        return split_unroll(net, views.reshape((T, -1) + views.shape[3:]),
                            feats.reshape(T, -1, feats.shape[-1]),
                            h0.reshape(-1, net.state_size), keep=keep)

    @torch.no_grad()
    def rollout_unroll(sk, state, hid):
        h0 = hid
        state, hid, traj = acting(nets, state, hid, sk, 0.3)
        s = 0.0
        for g in range(G):
            s = s + unroll_q(g, nets[g], h0[g], traj)[..., 0, 0].sum()
            s = s + unroll_q(g, target_nets[g], h0[g], traj)[..., 0, 0].sum()
        return (state, hid), s

    def full(sk, p, tp, opt, state, hid):
        p, opt, state, hid, metrics = step(p, tp, opt, state, hid, sk, 0.3)
        return (p, tp, opt, state, hid), metrics["loss"].sum()

    return {
        "env_only": timed("env_only", env_only, env_state),
        "rollout": timed("rollout", rollout_only, env_state, hiddens),
        "rollout+unr": timed("rollout+unr", rollout_unroll, env_state,
                             hiddens),
        "full": timed("full", full, nets, target_nets, opt_states,
                      env_state, hiddens),
    }


if __name__ == "__main__":
    main()
