"""``drqn_train``: the fused DRQN trainer's loop
(``make_drqn_train_loop``: the e-greedy acting unroll under autograd with
each step checkpointed, the target nets' re-unroll of the stored window,
one double-DQN TD step per group back-propagated through time), one call
of ``steps_per_call`` train steps at a time, carrying every agent slot's
GRU state across calls; judged over its recorded calls by
:func:`h100bench.check_drqn.check_drqn`.

As :class:`h100bench.loops.DqnTrainLoop` records its calls, this loop
records set-up's first calls (as many as ``checked_steps`` train steps
need) and the first call after the window, each with its start (env
state, nets, target nets, Adam moments and count, the GRU states), the
transitions and losses of its checked train steps, Adam's first moments
after the first update, the parameters after the last checked step and
the GRU states at the end of each call."""

from __future__ import annotations

import copy
import math
import time

import torch

from .. import world as worldlib
from ..loops import DTYPES, _ranges, make_venv
from ..reference import drqn as refdrqn
from .dqn_train import Loop as DqnTrain


class Loop(DqnTrain):
    def __init__(self, cfg, traffic, seed, device):
        from magent_tpu_torch import random as rnd
        from magent_tpu_torch.builtin.torch_model import DRQNNet
        from magent_tpu_torch.parallel import (ClipAdam, init_drqn_hiddens,
                                               make_drqn_train_loop)

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.rnd = rnd
        t = traffic
        self.n_envs = cfg["n_envs"]
        self.venv = venv = make_venv(cfg, device, self.n_envs)
        spec = venv.spec
        net_cfg = cfg["net"]
        nets = []
        gen = torch.Generator(device=device)
        for g in range(spec.n_groups):
            n_act = spec.groups[g].type.n_action
            shapes = refdrqn.param_shapes(spec.view_space(g), spec.feature_size(g),
                                          n_act, net_cfg)
            gen.manual_seed((seed * 8 + g) % 2**63)
            net = DRQNNet(spec.view_space(g), spec.feature_size(g), n_act,
                          use_dueling=net_cfg["dueling"],
                          state_size=net_cfg["state_size"],
                          dtype=DTYPES[net_cfg["dtype"]]).to(device)
            net.load_state_dict(refdrqn.init_params(shapes, gen, device))
            nets.append(net)
        self.tx = ClipAdam(t["lr"], t["clip"])
        self.nets = tuple(nets)
        self.targets = tuple(copy.deepcopy(n) for n in nets)
        self.opts = tuple(self.tx.init(n) for n in nets)
        self.hiddens = init_drqn_hiddens(venv, self.nets)
        self.spc = int(t["steps_per_call"])
        self.loop = make_drqn_train_loop(
            venv, self.tx, steps_per_call=self.spc,
            target_update=int(t["target_update"]), rollout_len=int(t["rollout"]),
            gamma=float(t["gamma"]), use_double=True,
            unroll_remat=t["unroll_remat"], share_acting=bool(t["share_acting"]))
        base = worldlib.seed_key(rnd, seed, device)
        self.reset_key = rnd.fold_in(base, 0)
        self.state = self.reset = venv.reset(self.reset_key)
        self.loop_key = rnd.fold_in(base, 1)
        self.eps = float(t["eps"])
        self.agents_per_train_step = (spec.n_agents_cap * self.n_envs
                                      * int(t["rollout"]))
        self.n_calls = 0
        self.n_train_steps = 0
        self.losses = []
        self.records = []

    def call(self, rf=_ranges(False)):
        c = self.n_calls
        out = self.loop(self.nets, self.targets, self.opts, self.state,
                        self.hiddens, self.rnd.fold_in(self.loop_key, c),
                        self.eps, c * self.spc)
        self.nets, self.targets, self.opts, self.state, self.hiddens, m = out
        self.losses.append(m["loss"])
        self.n_calls += 1
        self.n_train_steps += self.spc

    def profiled_step(self, rf):
        """One train step through the loop's own ``train_step`` (the
        profiled stretch), on the key the next call would not use."""
        skey = self.rnd.fold_in(self.loop_key, 2**31 - 1)
        with rf("train_step"):
            self.nets, self.opts, self.state, self.hiddens, m = \
                self.loop.train_step(self.nets, self.targets, self.opts,
                                     self.state, self.hiddens, skey, self.eps)
        self.losses.append(m["loss"][None])
        self.n_train_steps += 1

    def _start(self):
        return dict(super()._start(), hiddens=[h.clone() for h in self.hiddens])

    def recorded_call(self, n_checked):
        """The calls that hold the next ``n_checked`` train steps, recorded
        for the check: their start, the transitions, losses and Adam state
        of those steps, and the GRU states at each call's end."""
        G = len(self.nets)
        rec = dict(call=self.n_calls, checked=n_checked, state=self.state,
                   start=self._start(), transitions=[], mu1=[None] * G,
                   params=[None] * G, updates=[0] * G, hiddens=[], loss=[])
        venv, tx = self.venv, self.tx
        transition, update = venv.transition, tx.update

        def rec_transition(state, actions):
            out = transition(state, actions)
            if min(rec["updates"]) < n_checked:
                rec["transitions"].append((actions,) + tuple(out))
            return out

        def rec_update(net, opt):
            opt = update(net, opt)
            g = next(i for i, n in enumerate(self.nets) if n is net)
            rec["updates"][g] += 1
            names = [k for k, _ in net.named_parameters()]
            if rec["updates"][g] == 1:
                rec["mu1"][g] = {k: m.clone() for k, m in zip(names, opt.mu)}
            if rec["updates"][g] == n_checked:
                rec["params"][g] = {k: v.detach().clone()
                                    for k, v in net.state_dict().items()}
            return opt

        venv.transition, tx.update = rec_transition, rec_update
        try:
            for _ in range(math.ceil(n_checked / self.spc)):
                self.call()
                rec["hiddens"].append([h.clone() for h in self.hiddens])
                rec["loss"].append(self.losses[-1])
        finally:
            del venv.transition, tx.update
        rec["loss"] = torch.cat(rec["loss"])
        self.read_sink()
        self.records.append(rec)

    def flops_per_train_step(self):
        from .. import flops_drqn

        spec = self.venv.spec
        total = 0
        for g in range(spec.n_groups):
            per = flops_drqn.drqn_forward(spec.view_space(g), spec.feature_size(g),
                                          spec.groups[g].type.n_action,
                                          self.cfg["net"])
            total += flops_drqn.drqn_train_step(
                per, spec.groups[g].cap * self.n_envs, int(self.traffic["rollout"]))
        return total

    def judge(self, cfg, traffic, seed, device):
        from .. import check_drqn

        got = check_drqn.check_drqn(self, cfg, traffic, seed, device)["program"]
        return got, sum(r["checked"] for r in self.records)

    def calibrate(self, cfg, traffic, seed, device, control):
        from .. import check_drqn

        sides = ("program",)
        if control:
            sides += ("control", "fault_no_reset", "fault_bptt_cut",
                      "fault_target_zero")
        t = time.perf_counter()
        out = check_drqn.check_drqn(self, cfg, traffic, seed, device, sides)
        out["reference_s"] = time.perf_counter() - t
        out["where"] = self.where
        return out

    def free(self):
        super().free()
        self.hiddens = None
