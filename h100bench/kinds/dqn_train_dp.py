"""``dqn_train_dp``: the fused DQN trainer data-parallel over ``dp`` cards
of one host (:class:`h100bench.loops.DqnTrainLoop` on a ``dp`` mesh), each
card stepping ``n_envs`` worlds of the configuration, judged on the
global batch by :func:`h100bench.check.check_train`.

Rank 0 is this process, on the first card; :mod:`h100bench.ranks` starts
the other ranks, one per card, and sends each the calls rank 0 makes.
Every rank builds its venv on the mesh (its own env rows of the global
batch), the same nets from the seed, and the trainer, which draws every
key at the global batch, sums each learn step's gradients over the ranks
(``nccl``) and takes the minibatch, ``train_minibatch`` draws over the
global window, where the draws fall.  So the ranks train as one card
would on the global batch, and rank 0 gathers the records of every
rank's env rows for the check: set-up's first call and the first after
the window, as ``dqn_train`` records them."""

from __future__ import annotations

from .. import loops, ranks
from .. import world as worldlib
from .dqn_train import Loop as DqnTrain


class Loop(DqnTrain):
    def __init__(self, cfg, traffic, seed, device, mesh=None):
        dp = int(traffic["dp"])
        self.ranks = None
        if mesh is None:  # rank 0: start the others
            self.ranks = ranks.Ranks(dp, device, cfg, traffic, seed)
            mesh = self.ranks.mesh
        self.mesh, self.quiet = mesh, False
        make = loops.make_venv
        # the trainer's venv on the mesh: this rank's rows of the global batch
        loops.make_venv = lambda c, d, n: _venv(c, mesh, n)
        try:
            super().__init__(dict(cfg, n_envs=int(cfg["n_envs"]) * dp),
                             traffic, seed, device)
        finally:
            loops.make_venv = make
        self.reset = ranks.full(self.reset, mesh)

    def call(self, rf=loops._ranges(False)):
        if self.ranks is not None and not self.quiet:
            self.ranks.send(ranks.CALL)
        super().call(rf)

    def recorded_call(self, n_checked):
        """The call recorded on every rank, its env rows gathered on rank 0
        (the workers keep no record)."""
        if self.ranks is not None:
            self.ranks.send(ranks.RECORD, n_checked)
        self.quiet = True
        try:
            super().recorded_call(n_checked)
        finally:
            self.quiet = False
        rec = self.records[-1]
        rec["state"] = ranks.full(rec["state"], self.mesh)
        rec["transitions"] = [tuple(ranks.full(t, self.mesh) for t in tr)
                              for tr in rec["transitions"]]
        if self.ranks is None:
            self.records.clear()

    def profiled_step(self, rf):
        if self.ranks is not None:
            self.ranks.send(ranks.PROFILED)
        super().profiled_step(rf)

    def free(self):
        if self.ranks is not None:
            self.ranks.stop()
            self.ranks = None
        super().free()


def _venv(cfg, mesh, n_envs):
    """:func:`h100bench.loops.make_venv` on ``mesh``."""
    from magent_tpu_torch import config as gw
    from magent_tpu_torch.parallel import VecGridWorld

    w = cfg["world"]
    wall, placed = worldlib.layout(w)
    return VecGridWorld(worldlib.build_config(w, gw), worldlib.caps(w),
                        n_envs=n_envs, placements=[p.tolist() for p in placed],
                        obs_dtype=loops.DTYPES[cfg["obs_dtype"]],
                        walls=worldlib.interior_walls(wall).tolist(),
                        mesh=mesh)
