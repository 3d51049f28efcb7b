"""The traffic generator: the loops that drive the program, one traffic
``kind`` to a file.

A traffic file (``traffic/<mix>.json``) names its ``kind`` and parameters;
the configuration file gives the world, the batch and the net.  The kind's
file ``kinds/<kind>.py`` holds its ``Loop``: a loop of this module (or a
new one) with what :mod:`h100bench.run` asks of every loop (its rate's
name, its steps, the profiled stretch, the judge; ``kinds/__init__.py``
lists them).  :data:`KINDS` finds the file by the kind's name.  The loops
take their inputs from the seed alone: the reset key, the loop key and
(for the trainer) the nets' initial weights, made on the device from a
``torch.Generator``.

- ``random_policy`` (:class:`EnvLoop`): ``magent_tpu_torch.tools.bench``'s
  loop body, frozen here: observe every group, draw uniform actions, step;
  the sink reads one value of every view and feature and env 0's reward,
  and the host reads the summed sink once, after the window.
- ``dqn_train`` (:class:`DqnTrainLoop`): the fused DQN trainer
  (``make_dqn_train_loop``) at ``tools/bench_train.py``'s constants, one
  call of ``steps_per_call`` train steps at a time.

Each loop keeps what the check needs (:mod:`h100bench.check`): the env
loop the states, actions and outputs of a few steps drawn from the seed;
the trainer two recorded calls, set-up's first and the first after the
window, through wrappers that the window's calls do not carry: each
call's start (env state, nets, target nets, Adam moments and count), the
transitions, losses, Adam's first moments after the first update and the
parameters after the last of its first checked train steps.

A new world needs no code here: its configuration (``configs/``), its
placement kind (``layouts/``) and, where the reference lacks its rules, a
file of ``reference/``.  A new trainer or loop is a file of ``kinds/``."""

from __future__ import annotations

import contextlib
import copy
import importlib

import numpy as np
import torch

from . import world as worldlib
from .reference import dqn as refdqn

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def make_venv(cfg, device, n_envs):
    """The configuration's ``VecGridWorld`` of ``n_envs`` lockstep envs on
    its layout (:func:`h100bench.world.layout`: the wall map, whose border
    the program adds itself and whose interior cells it is given, and the
    start places)."""
    from magent_tpu_torch import config as gw
    from magent_tpu_torch.parallel import VecGridWorld

    w = cfg["world"]
    wall, placed = worldlib.layout(w)
    return VecGridWorld(worldlib.build_config(w, gw), worldlib.caps(w),
                        n_envs=n_envs, placements=[p.tolist() for p in placed],
                        obs_dtype=DTYPES[cfg["obs_dtype"]],
                        walls=worldlib.interior_walls(wall).tolist(),
                        device=device)


def _ranges(trace):
    if not trace:
        return lambda name: contextlib.nullcontext()
    return torch.profiler.record_function


class EnvLoop:
    """``random_policy``: lockstep envs under uniform random actions."""

    def __init__(self, cfg, traffic, seed, device):
        from magent_tpu_torch import random as rnd

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.rnd = rnd
        self.n_envs = int(traffic.get("n_envs", cfg["n_envs"]))
        self.venv = make_venv(cfg, device, self.n_envs)
        base = worldlib.seed_key(rnd, seed, device)
        self.reset_key = rnd.fold_in(base, 0)
        self.state = self.reset = self.venv.reset(self.reset_key)
        self.key = rnd.fold_in(base, 1)
        spec = self.venv.spec
        self.agents_per_step = spec.n_agents_cap * self.n_envs
        self.n_steps = 0
        self.sinks = []
        self.keep_at = set()
        self.kept = {}

    def step(self, rf=_ranges(False)):
        venv, rnd = self.venv, self.rnd
        key, akey = rnd.split(self.key).unbind(-2)
        state = self.state
        with rf("observe"):
            obs = venv.observe_all(state)
            s = 0.0
            for view, feat in obs:
                s = s + view[:, :, 0, 0, 0].sum() + feat[:, :, 0].sum()
        with rf("rng"):
            actions = venv.random_actions(akey)
        with rf("engine"):
            nxt, rewards, alive, done = venv.transition(state, actions)
        self.sinks.append(s + rewards[:, 0].sum())
        if self.n_steps in self.keep_at:  # references only: nothing copied
            self.kept[self.n_steps] = dict(state=state, obs=obs,
                                           actions=actions, next=nxt,
                                           rewards=rewards, alive=alive,
                                           done=done)
        self.state, self.key = nxt, key
        self.n_steps += 1

    def warm(self):
        """Every shape of the window: the first steps, read back."""
        with torch.no_grad():
            for _ in range(2):
                self.step()
        self.read_sink()

    def read_sink(self):
        s = float(torch.stack(self.sinks).sum()) if self.sinks else 0.0
        self.sinks = []
        return s

    def plan_checks(self, expected_steps):
        """Steps kept for the check: ``checked_steps`` drawn from the seed
        among those the window should reach."""
        rng = np.random.default_rng([self.seed, 7])
        n = int(self.traffic["checked_steps"])
        lo = self.n_steps
        hi = lo + max(int(expected_steps), n)
        self.keep_at = set(int(i) for i in rng.choice(
            np.arange(lo, hi), size=n, replace=False))

    def work_per_call(self):
        return self.agents_per_step

    def step_bytes(self):
        """The least bytes an env step moves: the observation it returns
        (views in their dtype, f32 features), written once, and per agent
        its action read and its reward and liveness written."""
        spec, B = self.venv.spec, self.n_envs
        vb = torch.empty((), dtype=DTYPES[self.cfg["obs_dtype"]]).element_size()
        total = 0
        for g in range(spec.n_groups):
            vh, vw, C = spec.view_space(g)
            total += B * spec.groups[g].cap * (vh * vw * C * vb
                                               + spec.feature_size(g) * 4)
        return total + B * spec.n_agents_cap * (4 + 4 + 1)

    def call(self, rf=_ranges(False)):
        with torch.no_grad():
            self.step(rf)

    def free(self):
        """Drop what the check does not read."""
        self.state = None
        self.sinks = []


class DqnTrainLoop:
    """``dqn_train``: the fused DQN trainer's loop."""

    def __init__(self, cfg, traffic, seed, device):
        from magent_tpu_torch import random as rnd
        from magent_tpu_torch.builtin.torch_model import DQNNet
        from magent_tpu_torch.parallel import ClipAdam, make_dqn_train_loop

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.rnd = rnd
        t = traffic
        self.n_envs = cfg["n_envs"]
        self.venv = venv = make_venv(cfg, device, self.n_envs)
        spec = venv.spec
        net_cfg = cfg["net"]
        self.init_params = []
        nets = []
        gen = torch.Generator(device=device)
        for g in range(spec.n_groups):
            shapes = refdqn.param_shapes(spec.view_space(g), spec.feature_size(g),
                                         spec.groups[g].type.n_action, net_cfg)
            gen.manual_seed((seed * 8 + g) % 2**63)
            params = refdqn.init_params(shapes, gen, device)
            net = DQNNet(spec.view_space(g), spec.feature_size(g),
                         spec.groups[g].type.n_action,
                         use_dueling=net_cfg["dueling"],
                         dtype=DTYPES[net_cfg["dtype"]]).to(device)
            net.load_state_dict(params)
            self.init_params.append({k: v.clone() for k, v in params.items()})
            nets.append(net)
        self.tx = ClipAdam(t["lr"], t["clip"])
        self.nets = tuple(nets)
        self.targets = tuple(copy.deepcopy(n) for n in nets)
        self.opts = tuple(self.tx.init(n) for n in nets)
        self.spc = int(t["steps_per_call"])
        self.loop = make_dqn_train_loop(
            venv, self.tx, steps_per_call=self.spc,
            target_update=int(t["target_update"]), rollout_len=int(t["rollout"]),
            train_minibatch=int(t["train_minibatch"]), gamma=float(t["gamma"]))
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

    def call_key(self, c):
        return self.rnd.fold_in(self.loop_key, c)

    def call(self, rf=_ranges(False)):
        c = self.n_calls
        out = self.loop(self.nets, self.targets, self.opts, self.state,
                        self.call_key(c), self.eps, c * self.spc)
        self.nets, self.targets, self.opts, self.state, m = out
        self.losses.append(m["loss"])
        self.n_calls += 1
        self.n_train_steps += self.spc

    def profiled_step(self, rf):
        """One train step through the loop's own ``train_step`` (the
        profiled stretch), on the key the next call would not use."""
        rnd = self.rnd
        skey = rnd.fold_in(self.loop_key, 2**31 - 1)
        with rf("train_step"):
            self.nets, self.opts, self.state, m = self.loop.train_step(
                self.nets, self.targets, self.opts, self.state, skey, self.eps)
        self.losses.append(m["loss"][None])
        self.n_train_steps += 1

    def _start(self):
        """The program's state before the next call, copied: Adam changes
        the parameters and its moments in place."""
        def named(net):
            return {k: v.detach().clone() for k, v in net.state_dict().items()}

        names = [[k for k, _ in n.named_parameters()] for n in self.nets]
        return dict(
            params=[named(n) for n in self.nets],
            targets=[named(n) for n in self.targets],
            mu=[dict(zip(k, (m.clone() for m in o.mu))) for k, o in zip(names, self.opts)],
            nu=[dict(zip(k, (v.clone() for v in o.nu))) for k, o in zip(names, self.opts)],
            count=[o.count for o in self.opts])

    def recorded_call(self, n_checked):
        """One call, recorded for the check: its start, and the transitions,
        losses and Adam state of its first ``n_checked`` train steps."""
        G = len(self.nets)
        rec = dict(call=self.n_calls, checked=n_checked, state=self.state,
                   start=self._start(), transitions=[], mu1=[None] * G,
                   params=[None] * G, updates=[0] * G)
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
            self.call()
        finally:
            del venv.transition, tx.update
        rec["loss"] = self.losses[-1]
        self.read_sink()
        self.records.append(rec)

    def warm(self):
        """Set-up's first call, recorded for the check."""
        self.recorded_call(int(self.traffic["checked_steps"]))

    def after_window(self):
        """The first call after the window, recorded for the check."""
        self.recorded_call(int(self.traffic["checked_steps_after"]))

    def read_sink(self):
        s = float(torch.stack(self.losses).sum()) if self.losses else 0.0
        self.losses = []
        return s

    def work_per_call(self):
        return self.agents_per_train_step * self.spc

    def flops_per_train_step(self):
        from . import flops as model_flops

        spec, t = self.venv.spec, self.traffic
        total = 0
        for g in range(spec.n_groups):
            per = model_flops.dqn_forward(spec.view_space(g), spec.feature_size(g),
                                          spec.groups[g].type.n_action,
                                          self.cfg["net"])
            acting = per["total"] * spec.groups[g].cap * self.n_envs * int(t["rollout"])
            learn = model_flops.dqn_learn(per, int(t["train_minibatch"]))
            total += acting + learn
        return total

    def free(self):
        self.state = None
        self.losses = []
        self.nets = self.targets = self.opts = None


class _Kinds:
    """``KINDS[kind]``: the ``Loop`` of ``kinds/<kind>.py``."""

    def __getitem__(self, kind):
        return importlib.import_module(".kinds." + kind, __package__).Loop


KINDS = _Kinds()
