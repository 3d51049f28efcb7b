"""Cross-play tournament between pursuit generations, the non-battle
analog of ``tournament`` (port of ``scripts/tournament_pursuit.py``).

Pursuit trains BOTH groups (predators and prey, ``train_evidence``), so a
"pairing" is predators of generation i hunting prey of generation j: the
full i x j cross-play matrix is scored by the mean per-step predator
reward over ``--eval_steps`` near-greedy steps of ``--n_envs`` lockstep
games.  Standings rank predator generations by mean catch across every
prey generation, and prey generations by mean evasion (negative catch
against them).

Inputs are the generations ``train_evidence --save_every`` saves (either
package's): save_model/<name>-g0/tfdqn_<k>.npz (predators) and <name>-g1
(prey)::

    python -m magent_tpu_torch.examples.train_evidence --game pursuit
        --n_round 2000 --save_every 250 --name pursuit-gen
    python -m magent_tpu_torch.examples.tournament_pursuit --name pursuit-gen
"""

import argparse
import os
import re

import numpy as np
import torch

from magent_tpu_torch import random as rnd
from magent_tpu_torch.builtin.torch_model import DQNNet, params_from_flax
from magent_tpu_torch.examples.train_evidence import pursuit_setup
from magent_tpu_torch.parallel import VecGridWorld, resolve_device
from magent_tpu_torch.parallel.train import _egreedy_actions


def list_generations(savedir, name):
    pat = re.compile(r"tfdqn_(\d+)\.npz")
    gens = sorted(int(m.group(1))
                  for f in os.listdir(os.path.join(savedir, name))
                  if (m := pat.match(f)))
    return gens


def cli():
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", default="pursuit-gen")
    ap.add_argument("--savedir", default="save_model")
    ap.add_argument("--map_size", type=int, default=64)
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--eval_steps", type=int, default=200)
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--pick_every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    return ap


def main(argv=None):
    """-> (generations, catch matrix)."""
    args = cli().parse_args(argv)
    device = resolve_device(args.device)
    cfg, caps, placements, train_groups, hero = pursuit_setup(args.map_size)
    venv = VecGridWorld(cfg, caps, n_envs=args.n_envs, placements=placements,
                        device=device)
    spec = venv.spec

    def load_gen(g, k):
        path = os.path.join(args.savedir, "%s-g%d" % (args.name, g),
                            "tfdqn_%d.npz" % k)
        net = DQNNet(spec.view_space(g), spec.feature_size(g),
                     spec.groups[g].type.n_action)
        with np.load(path) as z:
            net.load_state_dict(params_from_flax(dict(z)))
        return net.to(device)

    gens = [list_generations(args.savedir, "%s-g%d" % (args.name, g))
            for g in train_groups]
    common = sorted(set(gens[0]) & set(gens[1]))[:: args.pick_every]
    print("generations:", common)
    if len(common) < 2:
        print("need at least two saved generations (train_evidence "
              "--save_every)")
        return common, None

    g = spec.groups[hero]
    hero_sl = slice(g.offset, g.offset + g.cap)

    @torch.no_grad()
    def catch_rate(nets, key):
        """Mean per-step predator reward over a near-greedy rollout."""
        state = venv.reset(rnd.PRNGKey(9, device))
        rews = []
        for _ in range(args.eval_steps):
            key, akey = rnd.split(key).unbind(-2)
            actions = _egreedy_actions(venv, nets, state, akey, args.eps,
                                       train_groups=train_groups)[0]
            state, rewards, alive, done = venv.transition(state, actions)
            rews.append(rewards[:, hero_sl].mean())
        return torch.stack(rews).mean()

    matrix = np.zeros((len(common), len(common)))
    for i, kp in enumerate(common):
        pred = load_gen(0, kp)
        for j, ky in enumerate(common):
            prey = load_gen(1, ky)
            score = float(catch_rate((pred, prey), rnd.PRNGKey(3, device)))
            matrix[i, j] = score
            print("pred gen %6d vs prey gen %6d -> catch %.4f"
                  % (kp, ky, score), flush=True)

    print("\ncatch matrix (rows: predator gen, cols: prey gen):")
    header = "          " + "  ".join("%8d" % k for k in common)
    print(header)
    for i, kp in enumerate(common):
        print("%8d  " % kp + "  ".join("%8.4f" % v for v in matrix[i]))

    print("\n===== predator standings (mean catch across prey gens) =====")
    for i in np.argsort(-matrix.mean(axis=1)):
        print("gen %6d : %.4f" % (common[i], matrix[i].mean()))
    print("\n===== prey standings (mean evasion = -catch against) =====")
    for j in np.argsort(matrix.mean(axis=0)):
        print("gen %6d : %.4f" % (common[j], -matrix[:, j].mean()))
    return common, matrix


if __name__ == "__main__":
    main()
