"""Fused-training throughput: trained agent-steps/s for dqn / a2c / drqn
(port of ``scripts/bench_train.py``).

Battle 2x1000 (the ``tools.bench`` geometry) with the rollout and the
gradient step of :mod:`magent_tpu_torch.parallel.train` run as one train
step.  The JAX script scans ``steps_per_call`` steps in one jitted program;
here the loop of ``make_*_train_loop`` runs them eagerly, and the host reads
the loss once after the timed calls (``bench_train.py:116-122``).  Prints one
JSON line per algorithm.

The JAX script's switches are arguments here, with its defaults:
``BENCH_N_ENVS`` ``--n_envs``, ``BENCH_ROLLOUT`` ``--rollout``, ``BENCH_SPC``
``--steps_per_call``, ``BENCH_OBS_DTYPE`` ``--obs_dtype``,
``BENCH_NET_DTYPE`` ``--net_dtype``, ``BENCH_SAMPLE_STEPS``
``--sample_steps``, ``BENCH_DRQN_REMAT`` ``--drqn_remat`` and
``BENCH_DRQN_SHARE`` ``--drqn_share``.

The JAX script initialises each group's net with flax's ``init`` from
``fold_in(PRNGKey(0), g)``, which the port cannot draw without JAX: here
each net takes flax's initializers from a ``torch.Generator`` seeded
``NET_SEED + g`` (:func:`fresh_nets`), and :func:`bench_alg` takes other
nets through ``nets`` (converted flax parameters, or trained weights).

    python -m magent_tpu_torch.tools.bench_train [dqn dqn_remat a2c drqn]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from .. import random as rnd
from ..builtin.config import battle
from ..parallel import (ClipAdam, VecGridWorld, init_drqn_hiddens,
                        make_a2c_train_loop, make_dqn_remat_train_loop,
                        make_dqn_train_loop, make_drqn_train_loop,
                        resolve_device)

N_PER_GROUP = 1000
MAP_SIZE = 200
CALLS = 3
# the JAX script's constants: optax clip_by_global_norm(5.0) + adam(1e-4),
# the Q loops' target refresh, minibatch and exploration
LR, CLIP = 1e-4, 5.0
TARGET_UPDATE, TRAIN_MINIBATCH, EPS = 40, 16384, 0.3
NET_SEED = 16
ALGS = ("dqn", "dqn_remat", "a2c", "drqn")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("algs", nargs="*", default=["dqn", "a2c", "drqn"],
                    help="of %s" % " ".join(ALGS))
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--rollout", type=int, default=8)
    ap.add_argument("--steps_per_call", type=int, default=4)
    ap.add_argument("--obs_dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--net_dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--sample_steps", type=int, default=2,
                    help="dqn_remat's re-rendered steps per train step")
    ap.add_argument("--drqn_remat", default="",
                    choices=["", "none", "dots", "all"],
                    help="'' keeps the factory's default ('all')")
    ap.add_argument("--drqn_share", type=int, default=1, choices=[0, 1],
                    help="0: the two-unroll DRQN loss")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    return ap


def fresh_nets(alg, spec, device, dtype, seed=NET_SEED, **net_kw):
    """One fresh net per group of trainer ``alg`` (``DQNNet``, ``A2CNet``
    or ``DRQNNet``, with ``net_kw``), flax's initializers drawn from
    ``torch.Generator`` seeds ``seed + group``."""
    from ..builtin.torch_model import A2CNet, DQNNet, DRQNNet
    from ..builtin.torch_model.flax_params import init_dense_

    nets = []
    for g in range(spec.n_groups):
        shape = (spec.view_space(g), spec.feature_size(g),
                 spec.groups[g].type.n_action)
        gen = torch.Generator().manual_seed(seed + g)
        if alg in ("a2c", "drqn"):
            cls = A2CNet if alg == "a2c" else DRQNNet
            net = cls(*shape, dtype=dtype, generator=gen, **net_kw)
        else:
            net = DQNNet(*shape, dtype=dtype, **net_kw)
            init_dense_(net, gen)
        nets.append(net.to(device))
    return tuple(nets)


def trainer_loop(alg, venv, tx, dtype, nets=None, *, rollout_len=8,
                 steps_per_call=4, sample_steps=2, share_acting=True,
                 **drqn_kw):
    """The loop of trainer ``alg`` at the JAX script's settings on ``venv``
    and its first carry, nets first (``nets``, default :func:`fresh_nets`;
    the target nets are copies), the env reset from ``PRNGKey(1)``
    (``bench_train.py:75-107``).  ``drqn_kw``: DRQN's ``unroll_remat``
    (default: the factory's, ``"all"``)."""
    dev, spec = venv.device, venv.spec
    common = dict(steps_per_call=steps_per_call, rollout_len=rollout_len)
    state = venv.reset(rnd.PRNGKey(1, dev))
    nets = fresh_nets(alg, spec, dev, dtype) if nets is None else tuple(nets)
    opts = tuple(tx.init(n) for n in nets)
    if alg == "a2c":
        return make_a2c_train_loop(venv, tx, **common), [nets, opts, state]
    targets = tuple(copy.deepcopy(n) for n in nets)
    if alg == "drqn":
        loop = make_drqn_train_loop(
            venv, tx, target_update=TARGET_UPDATE, share_acting=share_acting,
            **drqn_kw, **common)
        return loop, [nets, targets, opts, state,
                      init_drqn_hiddens(venv, nets)]
    if alg == "dqn":
        loop = make_dqn_train_loop(
            venv, tx, target_update=TARGET_UPDATE,
            train_minibatch=TRAIN_MINIBATCH, **common)
    else:
        loop = make_dqn_remat_train_loop(
            venv, tx, target_update=TARGET_UPDATE,
            sample_steps=sample_steps, **common)
    return loop, [nets, targets, opts, state]


def trainer_args(alg, key, c=0, step=False, steps_per_call=4):
    """The arguments after the carry of call ``c`` of trainer ``alg``'s
    loop (or, with ``step``, of one train step): the key, and for the Q
    trainers eps and the loop's step0 (``bench_train.py:103-113``)."""
    if alg == "a2c":
        return (key,)
    return (key, EPS) if step else (key, EPS, c * steps_per_call)


def loop_kwargs(args):
    """:func:`trainer_loop`'s keywords from the command line."""
    kw = dict(rollout_len=args.rollout, steps_per_call=args.steps_per_call,
              sample_steps=args.sample_steps,
              share_acting=args.drqn_share != 0)
    if args.drqn_remat:
        kw["unroll_remat"] = (False if args.drqn_remat == "none"
                              else args.drqn_remat)
    return kw


def build(args, alg, device, nets=None):
    """-> (loop, carry) of trainer ``alg`` on a fresh venv."""
    venv = VecGridWorld(battle.get_config(MAP_SIZE),
                        [N_PER_GROUP, N_PER_GROUP], n_envs=args.n_envs,
                        obs_dtype=DTYPES[args.obs_dtype], device=device)
    return trainer_loop(alg, venv, ClipAdam(LR, CLIP),
                        DTYPES[args.net_dtype], nets, **loop_kwargs(args))


def bench_alg(args, alg, device, nets=None):
    """One warm call and ``CALLS`` timed calls of trainer ``alg`` ->
    {"record": the printed JSON, "metrics": each call's metrics, "carry"}."""
    loop, carry = build(args, alg, device, nets)
    lk = rnd.PRNGKey(2, device)
    spc = args.steps_per_call

    def call(c):
        out = loop(*carry, *trainer_args(alg, rnd.fold_in(lk, c), c,
                                         steps_per_call=spc))
        carry[:] = out[:-1]
        return out[-1]

    metrics = [call(0)]
    float(metrics[0]["loss"].sum())
    t0 = time.perf_counter()
    for c in range(1, CALLS + 1):
        metrics.append(call(c))
    float(metrics[-1]["loss"].sum())
    dt = time.perf_counter() - t0

    agent_steps = 2 * N_PER_GROUP * args.n_envs * args.rollout * spc * CALLS
    record = {
        "metric": "battle_2x1000_trained_agent_steps_per_s",
        "alg": alg,
        "value": round(agent_steps / dt, 1),
        "unit": "agent-steps/s",
    }
    print(json.dumps(record), flush=True)
    return {"record": record, "metrics": metrics, "carry": carry}


def main(argv=None):
    ap = cli()
    args = ap.parse_args(argv)
    if set(args.algs) - set(ALGS):
        ap.error("algs must be of %s" % " ".join(ALGS))
    device = resolve_device(args.device)
    return [bench_alg(args, alg, device) for alg in args.algs]


if __name__ == "__main__":
    main()
