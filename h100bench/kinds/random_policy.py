"""``random_policy``: lockstep envs under uniform random actions
(:class:`h100bench.loops.EnvLoop`), judged step by step by
:func:`h100bench.check.check_env`."""

import time

from ..loops import EnvLoop


class Loop(EnvLoop):
    rate = "env_agent_steps_per_s"
    window_steps, unit, steps_per_call = "env_steps", "env steps", 1

    @property
    def agents_per_profiled_step(self):
        return self.agents_per_step

    def before_window(self, seconds, run_window):
        """Steps the window should reach, for the steps kept for the
        check."""
        probe = run_window(self, 0.25)
        self.plan_checks(seconds * probe["calls"] / probe["seconds"] * 0.8)

    def after_window(self):
        pass

    def context(self):
        return dict(step_bytes=self.step_bytes())

    def traced_context(self, count_syncs):
        return {}

    def profile(self, rf):
        n = int(self.traffic["profiled_steps"])
        for _ in range(n):
            self.call(rf)
        return n

    def judge(self, cfg, traffic, seed, device):
        from .. import check

        return check.check_env(self, cfg, seed, device)

    def calibrate(self, cfg, traffic, seed, device, control):
        from .. import check

        t = time.perf_counter()
        out = dict(program=check.check_env(self, cfg, seed, device)[0])
        out["reference_s"] = time.perf_counter() - t
        if control:
            out["control"] = check.check_env(self, cfg, seed, device,
                                             control=True)[0]
        return out
