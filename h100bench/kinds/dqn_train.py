"""``dqn_train``: the fused DQN trainer's loop
(:class:`h100bench.loops.DqnTrainLoop`), judged over its recorded calls by
:func:`h100bench.check.check_train`."""

import time

from ..loops import DqnTrainLoop


class Loop(DqnTrainLoop):
    rate = "train_agent_steps_per_s"
    window_steps, unit = "train_steps", "train steps"

    @property
    def steps_per_call(self):
        return self.spc

    @property
    def agents_per_profiled_step(self):
        return self.agents_per_train_step

    def before_window(self, seconds, run_window):
        pass

    def context(self):
        return dict(flops_per_train_step=self.flops_per_train_step())

    def traced_context(self, count_syncs):
        return dict(syncs_per_train_step=count_syncs(self) / self.spc)

    def profile(self, rf):
        n = int(self.traffic["profiled_train_steps"])
        for _ in range(n):
            self.profiled_step(rf)
        return n

    def judge(self, cfg, traffic, seed, device):
        from .. import check

        got = check.check_train(self, cfg, traffic, seed, device)["program"]
        return got, sum(r["checked"] for r in self.records)

    def calibrate(self, cfg, traffic, seed, device, control):
        from .. import check

        sides = ("program",)
        if control:
            sides += ("control", "fault_half_batch")
        t = time.perf_counter()
        out = check.check_train(self, cfg, traffic, seed, device, sides)
        out["reference_s"] = time.perf_counter() - t
        out["where"] = self.where
        return out
