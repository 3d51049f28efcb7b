"""Differential for the segmented pair sweeps (port of
``scripts/test/diff_seg_chip.py``): the gridless step must stay bit-exact
with the grid-maintaining step on one forest world.  The port's
``make_step`` takes the y-segmented sweeps (PERF.md §6 rows 9-11) for one
multi-cell world of ``QUAD_MAX_SINGLE`` to ``SEG_DEFAULT_MAX`` slots,
where the JAX script opts in with ``MAGENT_SEG=1``; below
``QUAD_MAX_SINGLE`` (the default ``n`` 6000) this diffs the pair-kernel
gridless path instead (still a valid check, flagged in the output).  The
grid step is ``make_step(maintain_grid=True)`` on the same spec and walls
(the JAX script's ``MAGENT_GRIDLESS=0``).

    python -m magent_tpu_torch.tools.diff_seg_chip [n] [steps] [--device cpu]
"""

import argparse
import math

import numpy as np
import torch

from .. import random as rnd
from ..core import engine
from ..examples.test_1m import load_forest
from ..ops import attack_prefix as ap
from ..parallel import VecGridWorld, resolve_device
from ..parallel.vec_env import _wall_map
from ..spec import OP_ATTACK, OP_COLLIDE

FIELDS = ("x", "y", "hp", "dead", "last_op", "op_obj", "next_reward")


def build(n, seed=3):
    map_size = int(math.sqrt(n * 20))
    cfg = load_forest(map_size)
    rng = np.random.RandomState(seed)
    taken = set()
    walls = []
    while len(walls) < n // 10:
        x, y = int(rng.randint(1, map_size - 1)), int(rng.randint(1, map_size - 1))
        if (x, y) not in taken:
            taken.add((x, y))
            walls.append([x, y])
    preds = []
    while len(preds) < n // 2:
        x, y = int(rng.randint(1, map_size - 3)), int(rng.randint(1, map_size - 3))
        block = [(x + dx, y + dy) for dx in range(2) for dy in range(2)]
        if not any(c in taken for c in block):
            taken.update(block)
            preds.append([x, y, 0])
    prey = []
    while len(prey) < n - n // 2:
        x, y = int(rng.randint(1, map_size - 2)), int(rng.randint(1, map_size - 2))
        if (x, y) not in taken:
            taken.add((x, y))
            prey.append([x, y, 0])
    return cfg, [n // 2, n - n // 2], [preds, prey], walls


def cli():
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap_.add_argument("n", type=int, nargs="?", default=6000)
    ap_.add_argument("steps", type=int, nargs="?", default=20)
    ap_.add_argument("--device", default=None,
                     help="default: the card (raises without one)")
    return ap_


@torch.no_grad()
def main(argv=None):
    """-> {"seg": the segmented sweeps engaged, "route", "steps"}; raises
    AssertionError at the first field that differs."""
    args = cli().parse_args(argv)
    device = resolve_device(args.device)
    n, steps = args.n, args.steps
    cfg, caps, placements, walls = build(n)
    v_free = VecGridWorld(cfg, caps, n_envs=1, placements=placements,
                          walls=walls, device=device)
    v_grid = VecGridWorld(cfg, caps, n_envs=1, placements=placements,
                          walls=walls, device=device)
    spec = v_free.spec
    v_grid._step = engine.make_step(spec, maintain_grid=True, n_envs=1,
                                    walls=_wall_map(spec, walls))
    seg_live = v_free._step.route.seg
    print("segmented sweeps engaged:", seg_live,
          "(A=%d, quad max %d)" % (n, ap.QUAD_MAX_SINGLE))

    s1 = v_grid.reset(rnd.PRNGKey(0, device))
    s2 = s1.replace()
    key = rnd.PRNGKey(1, device)
    saw_c = saw_a = False
    for t in range(steps):
        key, akey = rnd.split(key).unbind(-2)
        acts = v_grid.random_actions(akey)
        st1 = v_grid.step(s1, acts)
        st2 = v_free.step(s2, acts)
        for name in FIELDS:
            a = getattr(st1, name).cpu().numpy()
            b = getattr(st2, name).cpu().numpy()
            if not np.array_equal(a, b):
                bad = np.flatnonzero((a != b).reshape(-1))[:10]
                print("MISMATCH step %d field %s at %s" % (t, name, bad))
                print(" grid:", a.reshape(-1)[bad])
                print(" free:", b.reshape(-1)[bad])
                raise AssertionError("diff_seg_chip: step %d field %s "
                                     "differs" % (t, name))
        saw_c |= bool((st1.last_op == OP_COLLIDE).any())
        saw_a |= bool((st1.last_op == OP_ATTACK).any())
        s1 = v_grid.transition(s1, acts)[0]
        s2 = v_free.transition(s2, acts)[0]
    assert saw_c and saw_a, (saw_c, saw_a)
    print("OK: %d steps bit-exact at A=%d (collide+attack events seen)"
          % (steps, n))
    return {"seg": seg_live, "route": v_free._step.route, "steps": steps}


if __name__ == "__main__":
    main()
