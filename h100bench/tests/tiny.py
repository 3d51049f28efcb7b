"""Tiny cells of the benchmark's configurations and mixes, for the CPU."""

import copy
import io
import json
import types

import torch

from h100bench import run, world

def entries(cell, net_dtype="f32"):
    """``cell``'s entries of ``BENCHMARK.json`` with its world cut to a 24
    x 24 map at the configuration's shares (each group as many as its
    layout places there), two envs, a short rollout and minibatch."""
    wl, cfg, traffic, per_layer, e2e = run.cell_entries(cell)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    w = cfg["world"]
    w["map_size"] = 24
    for g, placed in zip(w["groups"], world.layout(w)[1]):
        g["n"] = len(placed)
    cfg["n_envs"] = 2
    traffic.pop("n_envs", None)
    if "net" in cfg:
        cfg["net"]["dtype"] = net_dtype
    if traffic["kind"] == "dqn_train":
        traffic.update(rollout=3, train_minibatch=64)
    return wl, cfg, traffic, per_layer, e2e


def run_tiny(cell, seed=2**31 + 5, net_dtype="f32", seconds=0.3):
    """One run of the tiny ``cell`` on the CPU with the cell's own limits
    -> (result, standard output, standard error)."""
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                                 trace=0, entries=entries(cell, net_dtype))
    out, err = io.StringIO(), io.StringIO()
    result = run.run_cell(args, device=torch.device("cpu"), out=out, err=err)
    return result, out.getvalue(), err.getvalue()


def last_line(text):
    return json.loads(text.strip().splitlines()[-1])
