"""Learning evidence for pursuit / gather / tiger on the fused trainer
(port of ``scripts/train_evidence.py``; reference claim: README.md:57
trains pursuit, gathering and battle).

One fused double-DQN trainer per scenario (``parallel.train``) with
scripted (random-acting, untrained) groups where the reference uses
RandomActor or inert agents: pursuit trains BOTH groups (predators 2x2,
prey faster), gather trains the agent group against static food, tiger
trains tigers against randomly wandering deer (double-attack rule).  The
env batch and the nets are placed on ``make_mesh()``'s mesh as the JAX
script places them (alone: a one-rank mesh on one device).

After training, an eval phase runs greedy (eps=0.05) rollouts with the
TRAINED nets and with the UNTRAINED init, printing the mean per-step
trained-group reward for both.  Reward curves stream to the usual ``round
k\\t ...`` log.  ``--save_every`` writes each trained group's nets as
``save_model/<name>-g<g>/tfdqn_<round>.npz`` under the JAX key names, so
either package's ``tournament_pursuit`` reads either package's
generations.  The JAX script draws its nets with flax's ``init``; here each
group's net takes flax's initializers from a seeded ``torch.Generator``
(``tools.bench_train.fresh_nets``), and :func:`setup` takes other nets.

    python -m magent_tpu_torch.examples.train_evidence --game pursuit
        --n_round 600 [--device cpu]
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
from magent_tpu_torch.builtin.torch_model import tensors_to_flax
from magent_tpu_torch.parallel import (ClipAdam, VecGridWorld, device_put,
                                       gather, make_dqn_train_loop,
                                       make_eval_q, make_mesh,
                                       param_sharding, sample_eval_set)
from magent_tpu_torch.parallel.train import _egreedy_actions, _global_mean
from magent_tpu_torch.tools.bench_train import fresh_nets


def pursuit_setup(map_size):
    from magent_tpu_torch.builtin.config import pursuit

    cfg = pursuit.get_config(map_size)
    n_pred = int(map_size * map_size * 0.0125)
    n_prey = int(map_size * map_size * 0.025)
    rng = np.random.RandomState(11)
    taken = set()
    preds, prey = [], []
    while len(preds) < n_pred:
        x = int(rng.randint(1, map_size - 3))
        y = int(rng.randint(1, map_size - 3))
        block = [(x + dx, y + dy) for dx in range(2) for dy in range(2)]
        if not any(c in taken for c in block):
            taken.update(block)
            preds.append([x, y, 0])
    while len(prey) < n_prey:
        x = int(rng.randint(1, map_size - 2))
        y = int(rng.randint(1, map_size - 2))
        if (x, y) not in taken:
            taken.add((x, y))
            prey.append([x, y, 0])
    # reference trains both groups (examples/train_pursuit.py:131-137)
    return cfg, [n_pred, n_prey], [preds, prey], (0, 1), 0


def gather_setup(map_size):
    from magent_tpu_torch.examples.train_gather import load_config

    cfg = load_config(map_size)
    cx = cy = map_size // 2

    def ring(out, frac, gap):
        half = int(map_size * frac) // 2
        for x in range(cx - half, cx + half + 1, gap):
            out += [[x, cy - half], [x, cy + half]]
        for y in range(cy - half, cy + half + 1, gap):
            out += [[cx - half, y], [cx + half, y]]

    players, food = [], []
    for frac, gap in [(0.9, 3), (0.8, 4), (0.7, 6)]:
        ring(players, frac, gap)
    for frac, gap in [(0.65, 10), (0.6, 10), (0.55, 10), (0.5, 4),
                      (0.45, 3), (0.4, 1), (0.3, 1)]:
        ring(food, frac, gap)
    for shrink in (2, 4, 6):
        ring(food, (map_size * 0.3 - shrink) / map_size, 1)
    food = list(dict.fromkeys(map(tuple, food)))
    players = [p for p in dict.fromkeys(map(tuple, players))
               if p not in set(food)]
    # group 0 = food (inert, scripted), group 1 = agents (trained)
    return (cfg, [len(food), len(players)],
            [[list(p) for p in food], [list(p) for p in players]], (1,), 1)


def tiger_setup(map_size):
    from magent_tpu_torch.builtin.config import double_attack

    cfg = double_attack.get_config(map_size)
    n_deer = int(map_size * map_size * 0.05)
    n_tiger = int(map_size * map_size * 0.01)
    # 1x1 bodies: random placement on the device (walls are border-only in
    # the lockstep reset)
    return cfg, [n_deer, n_tiger], None, (1,), 1


SETUPS = {"pursuit": pursuit_setup, "gather": gather_setup,
          "tiger": tiger_setup}


def cli():
    ap = argparse.ArgumentParser()
    ap.add_argument("--game", choices=sorted(SETUPS), required=True)
    ap.add_argument("--map_size", type=int, default=64)
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--n_round", type=int, default=600,
                    help="train-step calls (each = rollout_len env steps)")
    ap.add_argument("--rollout_len", type=int, default=8)
    ap.add_argument("--steps_per_call", type=int, default=10)
    ap.add_argument("--target_update", type=int, default=40)
    ap.add_argument("--eval_steps", type=int, default=200)
    ap.add_argument("--eval_every", type=int, default=0,
                    help="greedy-eval the live nets every N rounds: a "
                         "per-generation strength curve")
    ap.add_argument("--save_every", type=int, default=0,
                    help="save each trained group's nets every N rounds "
                         "to save_model/<name>-g<g>/tfdqn_<round>.npz — the "
                         "generations tournament_pursuit cross-plays")
    ap.add_argument("--name", default=None,
                    help="checkpoint name prefix (default: evidence-<game>)")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    return ap


def setup(args, nets=None):
    """The scenario's envs, nets (``nets``: one per group, None for a
    scripted group; default fresh), optimizer states and train loop,
    placed on the mesh -> a namespace (``call(c, eps)`` runs loop call
    ``c`` on ``carry``)."""
    cfg, caps, placements, train_groups, hero = SETUPS[args.game](
        args.map_size)
    mesh = make_mesh(devices=args.device)
    venv = VecGridWorld(cfg, caps, n_envs=args.n_envs, placements=placements,
                        mesh=mesh)
    spec, dev = venv.spec, venv.device
    if nets is None:
        nets = fresh_nets("dqn", spec, dev, torch.float32)
    # scripted groups: no net (the JAX script's empty params)
    nets = tuple(n.to(dev) if g in train_groups else None
                 for g, n in enumerate(nets))
    init_nets = tuple(copy.deepcopy(n) for n in nets)
    tx = ClipAdam(1e-4, 5.0)

    def place(tree):
        return tuple(None if n is None else device_put(
            t, param_sharding(mesh, n)) for n, t in zip(nets, tree))

    opt_states = place(tuple(None if n is None else tx.init(n)
                             for n in nets))
    target_nets = place(tuple(copy.deepcopy(n) for n in nets))
    nets = place(nets)
    loop = make_dqn_train_loop(
        venv, tx, steps_per_call=args.steps_per_call,
        target_update=args.target_update, rollout_len=args.rollout_len,
        train_groups=train_groups)
    carry = [nets, target_nets, opt_states, venv.reset(rnd.PRNGKey(1, dev))]
    step_key = rnd.PRNGKey(2, dev)

    def call(c, eps):
        out = loop(*carry, rnd.fold_in(step_key, c), eps,
                   c * args.steps_per_call)
        carry[:] = out[:-1]
        return out[-1]

    return SimpleNamespace(venv=venv, mesh=mesh, caps=caps, hero=hero,
                           train_groups=train_groups, init_nets=init_nets,
                           carry=carry, call=call, place=place)


@torch.no_grad()
def eval_reward(ex, nets, eval_steps):
    """Mean per-step reward of the hero group over ``eval_steps`` e-greedy
    (eps 0.05) steps from ``reset(PRNGKey(9))`` with key ``PRNGKey(10)``
    (``train_evidence.py:183-197``) -> a 0-d tensor on the device."""
    venv, dev = ex.venv, ex.venv.device
    g = venv.spec.groups[ex.hero]
    sl = slice(g.offset, g.offset + g.cap)
    state, key = venv.reset(rnd.PRNGKey(9, dev)), rnd.PRNGKey(10, dev)
    rews = []
    for _ in range(eval_steps):
        key, akey = rnd.split(key).unbind(-2)
        actions = _egreedy_actions(venv, nets, state, akey, 0.05,
                                   train_groups=ex.train_groups)[0]
        state, rewards, alive, done = venv.transition(state, actions)
        rews.append(_global_mean(venv, rewards[:, sl]))
    return torch.stack(rews).mean()


def main(argv=None, nets=None):
    """-> {"trained", "untrained", "curve", "ex"}; ``nets``: :func:`setup`'s."""
    args = cli().parse_args(argv)
    magent.utility.init_logger("evidence-%s" % args.game)
    ex = setup(args, nets)
    lead = ex.mesh.rank == 0  # rank 0 alone prints and saves
    print("game:", args.game, "caps:", ex.caps, "train_groups:",
          ex.train_groups)
    if args.eval_every:
        ev_views, ev_feats = sample_eval_set(ex.venv, ex.hero)
        evq = make_eval_q(ex.venv, ex.hero)
    curve = []
    for attr in ("eval_every", "save_every"):
        v = getattr(args, attr)
        if v and v % args.steps_per_call:
            # fires on call boundaries; align rather than silently skip
            v = -(-v // args.steps_per_call) * args.steps_per_call
            setattr(args, attr, v)
            print("%s rounded up to %d (steps_per_call boundary)"
                  % (attr, v))
    ckpt_name = args.name or ("evidence-%s" % args.game)

    def save_generation(round_k, nets):
        for g in ex.train_groups:
            flat = tensors_to_flax(gather(nets[g]))  # every rank
            if not lead:
                continue
            savedir = os.path.join("save_model", "%s-g%d" % (ckpt_name, g))
            os.makedirs(savedir, exist_ok=True)
            np.savez(os.path.join(savedir, "tfdqn_%d.npz" % round_k), **flat)
        if lead:
            print("saved generation", round_k)

    if args.save_every:
        save_generation(0, ex.carry[0])  # the untrained anchor generation

    start = time.time()
    n_calls = -(-args.n_round // args.steps_per_call)
    for c in range(n_calls):
        k = c * args.steps_per_call
        eps = magent.utility.piecewise_decay(
            k, [0, args.n_round // 3, args.n_round], [1, 0.2, 0.05])
        metrics = ex.call(c, eps)
        if c % 5 == 0 or c == n_calls - 1:
            loss = metrics["loss"][-1].cpu().numpy()
            rew = metrics["mean_reward"][-1].cpu().numpy()
            log.info("round %d\t loss: %s\t reward: %s\t elapsed: %.1fs"
                     % (k, np.round(loss, 4).tolist(),
                        np.round(rew, 4).tolist(), time.time() - start))
        gen = k + args.steps_per_call
        if args.save_every and gen % args.save_every == 0:
            save_generation(gen, ex.carry[0])
        if args.eval_every and gen % args.eval_every == 0:
            g_ev = float(eval_reward(ex, ex.carry[0], args.eval_steps))
            q_on = float(evq(ex.carry[0], ev_views, ev_feats))
            q_tg = float(evq(ex.carry[1], ev_views, ev_feats))
            curve.append((gen, g_ev))
            print("GEN %s round %d: eval=%.5f evalq=%.4f targetq=%.4f"
                  % (args.game, gen, g_ev, q_on, q_tg))
            log.info("generation %d\t eval: %.5f\t evalq: %.4f\t "
                     "targetq: %.4f" % (gen, g_ev, q_on, q_tg))

    if curve:
        print("GENERATION CURVE %s: %s"
              % (args.game, " ".join("%d:%.4f" % g for g in curve)))

    # ---- trained vs untrained init, same seeds ----
    trained = float(eval_reward(ex, ex.carry[0], args.eval_steps))
    untrained = float(eval_reward(ex, ex.place(ex.init_nets),
                                  args.eval_steps))
    print("EVAL %s: trained=%.5f untrained=%.5f (mean per-agent per-step "
          "reward of group %d over %d greedy steps)"
          % (args.game, trained, untrained, ex.hero, args.eval_steps))
    log.info("eval\t trained: %.5f\t untrained: %.5f" % (trained, untrained))
    return {"trained": trained, "untrained": untrained, "curve": curve,
            "ex": ex}


if __name__ == "__main__":
    main()
