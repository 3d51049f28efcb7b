"""Multi-process launcher: the lockstep env loop or the fused DQN trainer
as ranks of one ``torch.distributed`` group over a ``("dp", "tp")`` mesh
(port of ``scripts/launch_multihost.py``).

The JAX script runs one SPMD program per host over a global device mesh;
the port runs one process per device:

- every rank runs THIS module with the same arguments plus its
  ``--proc_id`` (its rank) and the ``--coordinator`` ``host:port`` of rank
  0's store; ``torch.distributed.init_process_group`` wires the group:
  ``nccl`` when every rank has a card of its own, ``gloo`` on the CPU or
  when ranks share a card (NCCL refuses two ranks on one GPU);
- the env batch is split over the mesh's ``dp`` axis (each rank steps its
  own env rows); the mesh's ``tp`` is 1, as in the JAX script
  (:func:`run` takes any mesh: a caller that builds one with
  ``make_mesh(tp=...)`` splits the nets' wide layers);
- with no ``--proc_id`` the module *launches* the ranks on this machine,
  polls them and kills the rest at the first nonzero exit.  The CPU rig:
  ``--cpu_devices_per_proc D`` starts ``nproc * D`` gloo CPU ranks (one
  device per rank, one intra-op thread each), so the record's
  ``n_devices`` is the JAX rig's ``nproc * D``.

Throughput methodology (weak scaling): run with ``--nproc 1`` then
``--nproc N`` at the same ``--envs_per_device``; efficiency =
agg_throughput(N) / (N * agg_throughput(1)).  Rank 0 prints one JSON line
with the aggregate agent-steps/s.  From the repository root::

    python -m magent_tpu_torch.examples.launch_multihost --nproc 2
        --cpu_devices_per_proc 2 --map_size 32 --agents_per_side 8
        [--mode train]
"""

from __future__ import annotations

import argparse
import copy
import json
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from .test_examples import module_env

FLAGS = ("nproc", "cpu_devices_per_proc", "map_size",
         "agents_per_side", "envs_per_device", "steps", "calls",
         "rollout_len")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--proc_id", type=int, default=None,
                   help="worker rank; omit to run the local launcher")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0 (auto for local launches)")
    p.add_argument("--cpu_devices_per_proc", type=int, default=0,
                   help="D gloo CPU ranks per process (test rig); 0 = one "
                        "rank per process on its card")
    p.add_argument("--mode", choices=["env", "train", "observe"],
                   default="env",
                   help="observe: the env loop with every group observed "
                        "(test_scaling's loop)")
    p.add_argument("--map_size", type=int, default=64)
    p.add_argument("--agents_per_side", type=int, default=64)
    p.add_argument("--envs_per_device", type=int, default=2)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--rollout_len", type=int, default=8)
    return p.parse_args(argv)


def world_size(args) -> int:
    return args.nproc * max(args.cpu_devices_per_proc, 1)


def free_port() -> int:
    """A TCP port free on this machine for rank 0's store."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_local(args, poll_s: float = 0.2, echo: bool = True) -> str:
    """Start ``world_size(args)`` ranks of this module on this machine and
    wait for them (:func:`run_ranks`).  -> rank 0's standard output
    (echoed with ``echo``)."""
    coord = "127.0.0.1:%d" % free_port()
    cmds = []
    for rank in range(world_size(args)):
        cmd = [sys.executable, "-m", "magent_tpu_torch.examples."
               "launch_multihost", "--proc_id", str(rank),
               "--coordinator", coord, "--mode", args.mode]
        for flag in FLAGS:
            cmd += ["--" + flag, str(getattr(args, flag))]
        cmds.append(cmd)
    text = run_ranks(cmds, poll_s)
    if echo:
        sys.stdout.write(text)
        sys.stdout.flush()
    return text


def run_ranks(cmds, poll_s: float = 0.2) -> str:
    """Run one process per command (rank ``i`` runs ``cmds[i]``, with the
    repository root on ``PYTHONPATH``) and poll them; the first nonzero
    exit kills the rest and raises ``SystemExit``.  -> rank 0's standard
    output."""
    procs = []
    with tempfile.TemporaryFile("w+") as out0:
        for rank, cmd in enumerate(cmds):
            procs.append(subprocess.Popen(
                cmd, env=module_env(), stdout=out0 if rank == 0 else None))
        # poll rather than wait in launch order: a crashed rank leaves the
        # others blocked in a collective, so the first nonzero exit must
        # kill the rest instead of hanging the launcher
        rc = [None] * len(procs)
        while any(r is None for r in rc):
            time.sleep(poll_s)
            for i, p in enumerate(procs):
                if rc[i] is None:
                    rc[i] = p.poll()
            if any(r not in (None, 0) for r in rc):
                for i, p in enumerate(procs):
                    if rc[i] is None:
                        p.kill()
                        rc[i] = p.wait()
                break
        out0.seek(0)
        text = out0.read()
    if any(rc):
        raise SystemExit("worker failed: rcs=%s" % rc)
    return text


def init_rank(args) -> torch.device:
    """Join the group at ``--coordinator`` as rank ``--proc_id`` -> the
    rank's device: the CPU in the rig, else its card."""
    world = world_size(args)
    if args.cpu_devices_per_proc:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        n_cards = torch.cuda.device_count()
        if not n_cards:
            raise RuntimeError("no CUDA device: pass --cpu_devices_per_proc "
                               "for gloo CPU ranks")
        device = torch.device("cuda", args.proc_id % n_cards)
        torch.cuda.set_device(device)
    backend = ("nccl" if device.type == "cuda"
               and world <= torch.cuda.device_count() else "gloo")
    dist.init_process_group(backend, init_method="tcp://" + args.coordinator,
                            rank=args.proc_id, world_size=world)
    return device


def run(args, mesh):
    """The workload of ``args.mode`` on this rank's part of ``mesh`` ->
    dict: ``record`` (rank 0's JSON line), ``venv``, ``state`` (this
    rank's env rows after the run) and, in train mode, ``nets``,
    ``opt_states``, ``placement`` and the last call's ``metrics``."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.parallel import VecGridWorld
    from magent_tpu_torch.parallel.sharding import all_reduce

    n_devices = mesh.size
    n_envs = args.envs_per_device * n_devices
    venv = VecGridWorld(battle.get_config(args.map_size),
                        [args.agents_per_side, args.agents_per_side],
                        n_envs=n_envs, mesh=mesh)
    dev = venv.device
    state = venv.reset(rnd.PRNGKey(0, dev))
    out = dict(venv=venv)

    def sync(t):
        # the global sum, read on the host: every rank's work is done
        return float(all_reduce(t, mesh, "dp"))

    if args.mode in ("env", "observe"):
        observe = args.mode == "observe"

        def call(state, key):
            sink = torch.zeros((), device=dev)
            with torch.no_grad():
                for _ in range(args.steps):
                    key, akey = rnd.split(key).unbind(-2)
                    if observe:
                        for view, _ in venv.observe_all(state):
                            sink = sink + view[:, 0, 0, 0, 0].float().sum()
                    acts = venv.random_actions(akey)
                    state, rew, alive, done = venv.transition(state, acts)
                    sink = sink + (rew[:, 0] if observe else rew).sum()
            return state, key, sink

        loop_key = rnd.PRNGKey(1, dev)
        state, loop_key, sink = call(state, loop_key)
        sync(sink)  # warm
        t0 = time.perf_counter()
        for _ in range(args.calls):
            state, loop_key, sink = call(state, loop_key)
        sync(sink)
        dt = time.perf_counter() - t0
        steps_done = args.steps * args.calls
    else:  # fused DQN training over the mesh
        from magent_tpu_torch.builtin.torch_model import DQNNet
        from magent_tpu_torch.builtin.torch_model.flax_params import (
            init_dense_)
        from magent_tpu_torch.parallel import (ClipAdam, device_put,
                                               make_dqn_train_loop,
                                               param_sharding)

        spec = venv.spec
        nets = []
        for g in range(2):
            net = DQNNet(spec.view_space(g), spec.feature_size(g),
                         spec.groups[g].type.n_action)
            init_dense_(net, torch.Generator().manual_seed(g))
            nets.append(net.to(dev))
        nets = tuple(nets)
        tx = ClipAdam(1e-4, max_norm=float("inf"))  # optax.adam(1e-4)
        opts = tuple(tx.init(n) for n in nets)
        tgt = tuple(copy.deepcopy(n).requires_grad_(False) for n in nets)
        placement = param_sharding(mesh, nets)
        nets = device_put(nets, placement)
        tgt = device_put(tgt, placement)
        opts = device_put(opts, placement)

        loop = make_dqn_train_loop(venv, tx, steps_per_call=2,
                                   target_update=40,
                                   rollout_len=args.rollout_len)
        lk = rnd.PRNGKey(2, dev)
        nets, tgt, opts, state, metrics = loop(nets, tgt, opts, state, lk,
                                               0.5, 0)
        sync(metrics["loss"].sum())
        t0 = time.perf_counter()
        for c in range(args.calls):
            nets, tgt, opts, state, metrics = loop(
                nets, tgt, opts, state, rnd.fold_in(lk, c), 0.5, 2 * (c + 1))
        sync(metrics["loss"].sum())
        dt = time.perf_counter() - t0
        steps_done = 2 * args.rollout_len * args.calls
        out.update(nets=nets, opt_states=opts, placement=placement,
                   metrics=metrics)

    agents = 2 * args.agents_per_side
    out["state"] = state
    out["record"] = {
        "mode": args.mode,
        "nproc": args.nproc,
        "n_devices": n_devices,
        "dp": mesh.shape["dp"],
        "tp": mesh.shape["tp"],
        "backend": dist.get_backend(),
        "n_envs": n_envs,
        "steps": steps_done,
        "seconds": dt,
        "agent_steps_per_s": (round(n_envs * agents * steps_done / dt, 1)
                              if dt > 0 else None),
    }
    return out


def worker(args):
    from magent_tpu_torch.parallel import make_mesh

    device = init_rank(args)
    try:
        mesh = make_mesh(devices=device)
        rec = run(args, mesh)["record"]
        if args.proc_id == 0:
            print(json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    if args.proc_id is None:
        launch_local(args)
    else:
        assert args.coordinator, "--coordinator required with --proc_id"
        worker(args)


if __name__ == "__main__":
    main()
