"""The ranks of the port's CPU mesh tests (JAX-free): one process per rank,
each joining a gloo group and running every case of a job on its part of a
``("dp", "tp")`` mesh, writing what it holds to ``<out>/<case>_rank<r>.npz``
for ``tests/test_torch_port_sharding.py`` to hold against the unsharded
runs.  Started by :func:`run_job` through the port's launcher
(``examples/launch_multihost.run_ranks``), each rank under its own
``timeout``.  A job may name its cases and put every rank on one card
(``tests/test_torch_port_gru_cell_gpu.py``: the gloo ranks copy their
collectives through host memory).

The cases' settings are the JAX tests' (``tests/test_sharding.py``: battle
map 24, [8, 8], B=8) and the fused example test's arguments."""

import argparse
import copy
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from magent_tpu_torch import random as rnd  # noqa: E402
from magent_tpu_torch.builtin.config import battle  # noqa: E402
from magent_tpu_torch.builtin.torch_model import (  # noqa: E402
    A2CNet, DQNNet, DRQNNet, params_from_flax, tensors_to_flax)
from magent_tpu_torch.core.state import FIELDS  # noqa: E402
from magent_tpu_torch.parallel import (  # noqa: E402
    ClipAdam, VecGridWorld, device_put, gather, init_drqn_hiddens,
    make_a2c_train_step, make_dqn_train_step, make_dqn_train_step_remat,
    make_drqn_train_step, make_mesh, param_sharding)

MAP, CAPS, B = 24, [8, 8], 8
ROLL_STEPS = 6
RANK_TIMEOUT_S = 150
# the fused example test's arguments (B=8 splits over 2 ranks)
FUSED_ARGV = ["--n_round", "1", "--steps_per_call", "1", "--map_size", "20",
              "--agents_per_side", "6", "--n_envs", "8", "--rollout_len",
              "3", "--train_minibatch", "32"]
JOBS = {2: ("rollout", "dqn", "dqn_unplaced", "dqnremat", "a2c", "drqn",
            "fused"),
        4: ("rollout", "dqn_tp", "a2c_tp", "drqn_tp")}


def venv_of(mesh=None, device="cpu"):
    """The cases' venv on ``mesh``'s device, else on ``device``."""
    return VecGridWorld(battle.get_config(MAP), CAPS, n_envs=B,
                        device=device if mesh is None else mesh.device,
                        mesh=mesh)


def rollout(venv, state):
    """``tests/test_sharding.py``'s ``_rollout``: ``ROLL_STEPS`` steps of
    random actions from ``PRNGKey(7)`` -> (state, rewards [T, B, A],
    alive [T, B, A])."""
    key = rnd.PRNGKey(7)
    rews, alives = [], []
    with torch.no_grad():
        for _ in range(ROLL_STEPS):
            key, akey = rnd.split(key).unbind(-2)
            state, rew, alive, _ = venv.transition(
                state, venv.random_actions(akey))
            rews.append(rew)
            alives.append(alive)
    return state, torch.stack(rews), torch.stack(alives)


def dqn_nets(venv, flat_params):
    """The DQN nets of the JAX test's parameters (flat flax dicts)."""
    spec = venv.spec
    nets = []
    for g in range(2):
        net = DQNNet(spec.view_space(g), spec.feature_size(g),
                     spec.groups[g].type.n_action)
        net.load_state_dict(params_from_flax(flat_params[g]))
        nets.append(net)
    return tuple(nets)


def fresh_nets(kind, venv):
    spec = venv.spec
    cls = {"a2c": A2CNet, "drqn": DRQNNet}[kind]
    kw = {"use_comm": True} if kind == "a2c" else {}
    return tuple(cls(spec.view_space(g), spec.feature_size(g),
                     spec.groups[g].type.n_action,
                     generator=torch.Generator().manual_seed(g), **kw)
                 .to(venv.device) for g in range(2))


def train_case(kind, venv, flat_params=None, place=True):
    """One train step of ``kind`` (``dqn``: the JAX test's step, Adam
    without clipping, from its parameters; ``dqnremat``: the remat step
    from them, sampling 2 of 3 steps; ``a2c``/``drqn``: fresh nets,
    ``ClipAdam(lr, 5)``) on ``venv``, the nets placed on its mesh where
    it has one and ``place`` (else replicated as built) -> (nets, opt
    states, placement, env state, metrics)."""
    mesh = venv.mesh
    if kind in ("dqn", "dqnremat"):
        nets = dqn_nets(venv, flat_params)
        tx = ClipAdam(1e-4, max_norm=float("inf"))
    else:
        nets = fresh_nets(kind, venv)
        tx = ClipAdam(1e-3 if kind == "a2c" else 1e-4, 5.0)
    opts = tuple(tx.init(n) for n in nets)
    tgt = tuple(copy.deepcopy(n).requires_grad_(False) for n in nets)
    placement = None
    if mesh is not None and place:
        placement = param_sharding(mesh, nets)
        nets = device_put(nets, placement)
        tgt = device_put(tgt, placement)
        opts = device_put(opts, placement)
    state = venv.reset(rnd.PRNGKey(1))
    key = rnd.PRNGKey(2).to(venv.device)
    if kind == "dqn":
        step = make_dqn_train_step(venv, tx, rollout_len=2)
        nets, opts, state, metrics = step(nets, tgt, opts, state, key, 0.5)
    elif kind == "dqnremat":
        step = make_dqn_train_step_remat(venv, tx, rollout_len=3,
                                         sample_steps=2)
        nets, opts, state, metrics = step(nets, tgt, opts, state, key, 0.5)
    elif kind == "a2c":
        step = make_a2c_train_step(venv, tx, rollout_len=3)
        nets, opts, state, metrics = step(nets, opts, state, key)
    else:
        step = make_drqn_train_step(venv, tx, rollout_len=3)
        hid = init_drqn_hiddens(venv, nets)
        nets, opts, state, _, metrics = step(nets, tgt, opts, state, hid,
                                             key, 0.5)
    return nets, opts, placement, state, metrics


def net_arrays(nets, opts, placement=None):
    """Per group: flat flax parameters, ``mu`` and ``nu`` (full tensors;
    gathered over the mesh where ``placement`` is given) -> one flat dict
    with ``g<g>/<kind>/<flax name>`` keys."""
    out = {}
    for g, (net, st) in enumerate(zip(nets, opts)):
        names = [n for n, _ in net.named_parameters()]
        params = gather(net) if placement else dict(net.named_parameters())
        if placement:
            st = gather(st, placement[g])
        for kind, tensors in (("param", params),
                              ("mu", dict(zip(names, st.mu))),
                              ("nu", dict(zip(names, st.nu)))):
            for k, v in tensors_to_flax(tensors).items():
                out["g%d/%s/%s" % (g, kind, k)] = v
    return out


def state_arrays(state):
    return {"state/" + f: getattr(state, f).cpu().numpy() for f in FIELDS}


def run_case(case, mesh, out_dir):
    rank = dist.get_rank()
    out = {}
    if case == "rollout":
        venv = venv_of(mesh)
        state, rews, alives = rollout(venv, venv.reset(rnd.PRNGKey(0)))
        out.update(rews=rews.numpy(), alives=alives.numpy(),
                   rows=np.asarray(venv.env_rows),
                   fast=venv.random_actions(rnd.PRNGKey(3),
                                            fast=True).numpy()[None])
        out.update(state_arrays(state))
    elif case.split("_")[0] in ("dqn", "dqnremat", "a2c", "drqn"):
        kind = case.split("_")[0]
        flat = None
        if kind in ("dqn", "dqnremat"):
            with np.load(os.path.join(out_dir, "dqn_params.npz")) as z:
                flat = [{k.split("/", 1)[1]: z[k] for k in z
                         if k.startswith("g%d/" % g)} for g in range(2)]
        venv = venv_of(mesh)
        nets, opts, placement, state, metrics = train_case(
            kind, venv, flat, place=not case.endswith("_unplaced"))
        out.update({"metric/" + k: v.cpu().numpy()
                    for k, v in metrics.items()})
        out.update(state_arrays(state))
        out["rows"] = np.asarray(venv.env_rows)
        out["dense_view_rows"] = np.asarray(
            [n.dense_view.weight.shape[0] if kind != "drqn" else
             n.trunk.dense_view.weight.shape[0] for n in nets])
        out.update(net_arrays(nets, opts, placement))
    elif case == "fused":
        out.update(fused_case(os.path.join(out_dir, "fused")))
    np.savez(os.path.join(out_dir, "%s_rank%d.npz" % (case, rank)), **out)


def fused_case(work_dir):
    """The fused example's ``main`` (dqn, one call of one train step) as
    one rank of the group: its metrics, this rank's env rows after the
    call, the carry's nets and optimizer states (gathered) and, rank 0,
    the saved checkpoints."""
    import magent_tpu_torch as tmag
    from magent_tpu_torch.examples import train_battle_fused as fused

    os.makedirs(work_dir, exist_ok=True)
    os.chdir(work_dir)
    made, calls = [], []
    setup, init_logger = fused.setup, tmag.utility.init_logger

    def recorded_setup(args):
        ex = setup(args)
        call = ex.call

        def recorded(c, eps):
            calls.append(call(c, eps))
            return calls[-1]

        ex.call = recorded
        made.append(ex)
        return ex

    fused.setup = recorded_setup
    tmag.utility.init_logger = lambda _: None
    try:
        fused.main(["--alg", "dqn", "--device", "cpu"] + FUSED_ARGV)
    finally:
        fused.setup, tmag.utility.init_logger = setup, init_logger
    ex, = made
    out = {"metric/" + k: v.numpy() for k, v in calls[0].items()}
    out.update(state_arrays(ex.carry[3]))
    out["rows"] = np.asarray(ex.venv.env_rows)
    out.update(net_arrays(ex.carry[0], ex.carry[2], ex.placement))
    return out


def run_job(world, out_dir, device="cpu", cases=None):
    """Start ``world`` ranks of this script on ``out_dir`` (each under its
    own ``timeout``), every rank's part of the mesh on ``device``, running
    ``cases`` (default: the world's ``JOBS``), and wait for them; raises if
    any rank fails."""
    from magent_tpu_torch.examples.launch_multihost import (free_port,
                                                            run_ranks)

    coord = "127.0.0.1:%d" % free_port()
    cmds = [["timeout", "-k", "5", str(RANK_TIMEOUT_S), sys.executable,
             os.path.abspath(__file__), "--rank", str(r), "--world",
             str(world), "--coordinator", coord, "--out", str(out_dir),
             "--device", str(device)]
            + ["--case=" + c for c in (cases or ())]
            for r in range(world)]
    run_ranks(cmds)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cpu")
    p.add_argument("--case", action="append", dest="cases")
    args = p.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://" + args.coordinator,
                            rank=args.rank, world_size=args.world)
    try:
        for case in args.cases or JOBS[args.world]:
            mesh = make_mesh(tp=2 if case.endswith("_tp") else 1,
                             devices=args.device)
            run_case(case, mesh, args.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
