"""A configuration file's world: its layout, and its ``Config`` for the
program.

``layout(world)`` makes the wall map and the start positions that the
benchmark hands to both the program and the reference, with NumPy.  Its
one kind, ``facing_squares``, is ``examples/train_battle.py``'s
``generate_map``: each group a square of agents two cells apart,
``density`` of the cells per group, the two squares ``gap`` cells either
side of the middle column, border walls only.

``build_config(world, gw)`` turns the ``world`` object into a gridworld
``Config`` of the program's DSL module ``gw`` (MAgent's
``gridworld.Config``)."""

from __future__ import annotations

import math

import numpy as np

RANGES = {"circle": "CircleRange"}


def _range(gw, spec):
    (kind, radius), = spec.items()
    return getattr(gw, RANGES[kind])(radius)


def build_config(world, gw):
    cfg = gw.Config()
    m = world["map_size"]
    cfg.set({"map_width": m, "map_height": m})
    if world.get("settings"):
        cfg.set(dict(world["settings"]))
    for name, attr in world["agent_types"].items():
        attr = dict(attr)
        for key in ("view_range", "attack_range"):
            attr[key] = _range(gw, attr[key])
        cfg.register_agent_type(name, attr)
    handles = [cfg.add_group(g["type"]) for g in world["groups"]]
    symbols = [gw.AgentSymbol(h, index="any") for h in handles]
    for rule in world["reward_rules"]:
        on = gw.Event(symbols[rule["subject"]], rule["event"],
                      symbols[rule["object"]])
        cfg.add_reward_rule(on, receiver=[symbols[r] for r in rule["receiver"]],
                            value=list(rule["value"]))
    return cfg


def caps(world):
    return [g["n"] for g in world["groups"]]


def border(m):
    wall = np.zeros((m, m), bool)  # [y, x]
    wall[0, :] = wall[-1, :] = wall[:, 0] = wall[:, -1] = True
    return wall


def facing_squares(world):
    m, p = world["map_size"], world["placement"]
    side = int(math.sqrt(int(m * m * p["density"]))) * 2
    y0 = (m - side) // 2

    def square(x0):
        return np.array([(x, y) for x in range(x0, x0 + side, 2)
                         for y in range(y0, y0 + side, 2)], np.int64)

    return [square(m // 2 - p["gap"] - side), square(m // 2 + p["gap"])]


def layout(world):
    """-> (wall [H, W] bool, border included; per group [n, 2] int64 (x,
    y) top-left cells)."""
    kind = world["placement"]["kind"]
    if kind == "facing_squares":
        return border(world["map_size"]), facing_squares(world)
    raise ValueError("no placement %r" % kind)


def seed_key(rnd, seed, device):
    """A threefry key of the program's random module ``rnd`` of a seed of
    any size: its low word, then its high bits folded in."""
    key = rnd.PRNGKey(seed & 0xFFFFFFFF, device)
    return rnd.fold_in(key, seed >> 32) if seed >> 32 else key
