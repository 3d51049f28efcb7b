"""The ranks of a data-parallel loop kind: one process per card, in
lockstep.

Rank 0 is the harness's own process; :class:`Ranks` launches ranks 1 to
``n - 1`` as workers (``python -m h100bench.ranks``, one per card) and
joins them in one process group: ``nccl`` over the cards (``gloo`` on the
CPU), with a ``gloo`` group beside it for the commands.  Each worker
builds the same loop on its own card (:func:`join` gives it the rank's
mesh) and then serves rank 0's commands until told to stop: rank 0 sends
one before every call it makes (:meth:`Ranks.send`), so every rank runs
each call, and each collective inside it, in the same order.  What the
check needs of every rank, rank 0 gathers (:func:`full`).

    python -m h100bench.ranks --rank <r> --world <n> --port <p> \
        --device <cuda|cpu> --job <json file>

The job file holds the configuration, the traffic and the seed that rank
0 was given."""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT = datetime.timedelta(seconds=300)
# the commands: a call, a recorded call (its argument the checked steps),
# a profiled train step, stop
CALL, RECORD, PROFILED, STOP = range(4)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_cmd(rank, world, port, device_type, job):
    return [sys.executable, "-m", "h100bench.ranks", "--rank", str(rank),
            "--world", str(world), "--port", str(port), "--device",
            device_type, "--job", job]


def join(rank, world, port, device_type):
    """Join the ranks' process group -> (this rank's ``dp`` mesh, the
    commands' ``gloo`` group)."""
    from magent_tpu_torch.parallel import make_mesh

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method="tcp://localhost:%d" % port,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    commands = dist.new_group(backend="gloo", timeout=TIMEOUT)
    devices = None if device_type == "cuda" else "cpu"
    return make_mesh(world, devices=devices), commands


class Ranks:
    """Rank 0's side: the workers it started and the commands' group."""

    def __init__(self, world, device, cfg, traffic, seed):
        self.job = tempfile.NamedTemporaryFile(
            "w", suffix=".json", prefix="h100bench_ranks_", delete=False)
        json.dump(dict(cfg=cfg, traffic=traffic, seed=seed), self.job)
        self.job.close()
        port = free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self.procs = [subprocess.Popen(
            worker_cmd(r, world, port, device.type, self.job.name), cwd=ROOT,
            env=env) for r in range(1, world)]
        self.mesh, self.commands = join(0, world, port, device.type)

    def send(self, command, arg=0):
        """Every worker runs ``command`` next (rank 0 runs it itself)."""
        msg = torch.tensor([command, arg], dtype=torch.int64)
        dist.broadcast(msg, 0, group=self.commands)

    def stop(self):
        """The workers' last command; every rank leaves the group at once
        (NCCL's teardown waits for all of them), then rank 0 waits for the
        workers."""
        self.send(STOP)
        dist.destroy_process_group()
        os.remove(self.job.name)
        rcs = [p.wait(timeout=TIMEOUT.total_seconds()) for p in self.procs]
        if any(rcs):
            raise RuntimeError("h100bench ranks: workers exited with %s" % rcs)


def full(t, mesh):
    """The tensor of every rank's env rows (dim 0), or the full State."""
    from magent_tpu_torch.core.state import FIELDS, State
    from magent_tpu_torch.parallel.sharding import all_gather

    if isinstance(t, State):
        return State(**{f: full(getattr(t, f), mesh) for f in FIELDS})
    if t.dtype == torch.bool:  # gathered as bytes
        return all_gather(t.to(torch.uint8), mesh, "dp").bool()
    return all_gather(t, mesh, "dp")


def serve(loop, commands):
    """A worker's part: run rank 0's commands on ``loop`` until STOP."""
    from .loops import _ranges

    msg = torch.zeros(2, dtype=torch.int64)
    while True:
        dist.broadcast(msg, 0, group=commands)
        command, arg = int(msg[0]), int(msg[1])
        if command == STOP:
            return
        if command == CALL:
            loop.call()
        elif command == RECORD:
            loop.recorded_call(arg)
        elif command == PROFILED:
            loop.profiled_step(_ranges(False))
        loop.losses.clear()  # rank 0 reads the loss: no sync here


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], required=True)
    ap.add_argument("--job", required=True)
    args = ap.parse_args(argv)
    from .kinds.dqn_train_dp import Loop
    from .run import set_cache_dirs

    set_cache_dirs()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    with open(args.job) as f:
        job = json.load(f)
    mesh, commands = join(args.rank, args.world, args.port, args.device)
    loop = Loop(job["cfg"], job["traffic"], job["seed"], mesh.device,
                mesh=mesh)
    serve(loop, commands)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
