"""A configuration file's world: its layout, and its ``Config`` for the
program.

``layout(world)`` makes the wall map and the start positions that the
benchmark hands to both the program and the reference, with NumPy, in the
file of the world's placement kind (``layouts/<kind>.py``).

``build_config(world, gw)`` turns the ``world`` object into a gridworld
``Config`` of the program's DSL module ``gw`` (MAgent's
``gridworld.Config``)."""

from __future__ import annotations

import importlib

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


def layout(world):
    """-> (wall [H, W] bool, border included; per group [n, 2] int64 (x,
    y) top-left cells) of the placement kind's file
    ``layouts/<kind>.py``."""
    kind = world["placement"]["kind"]
    return importlib.import_module(".layouts." + kind, __package__).layout(world)


def interior_walls(wall):
    """The (x, y) cells of a full wall map that are not on its border."""
    inner = wall.copy()
    inner[0, :] = inner[-1, :] = inner[:, 0] = inner[:, -1] = False
    ys, xs = np.nonzero(inner)
    return np.stack([xs, ys], 1)


def seed_key(rnd, seed, device):
    """A threefry key of the program's random module ``rnd`` of a seed of
    any size: its low word, then its high bits folded in."""
    key = rnd.PRNGKey(seed & 0xFFFFFFFF, device)
    return rnd.fold_in(key, seed >> 32) if seed >> 32 else key
