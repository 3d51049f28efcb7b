"""The comparison that decides ``correct``: the program's outputs against
the plain reference (:mod:`h100bench.reference`), after the window.

The reference imports nothing of the program.  It takes the benchmark's
inputs (the configuration and its layout, the seed's keys, the
nets' initial weights) and reads the program's outputs only to judge them.

- ``random_policy`` cells: the reset, from the reset key; then at each
  step kept from the window, the reference observes, draws and steps from
  the program's state before that step (its keys worked out again from
  the seed) and is compared with what the program produced there.
- ``dqn_train`` cells, twice: set-up's first train steps, which the
  reference follows from its own reset and the nets' initial weights; and
  the first train steps of the call after the window, which it follows
  from the program's state when that call began (env, nets, target nets,
  Adam moments and count), after checking that what the calls before it
  carried (step counters, keys, Adam's count) is that many steps on.  In
  each it draws the exploration itself, judges each greedy action by its
  own Q values, steps its own env with the program's actions, draws the
  minibatch and takes the loss, the gradient and the Adam step in
  float32; the gradient is compared at set-up's first step.

Every number is a gap that has to stay at or under its limit
(``limits/<cell>.json``); ``ints_differing`` counts integer and boolean
elements that differ, with the limit 0.

``control``: the reference put in the program's place and computed in the
nearest precision below the configuration's (float32 hp and rewards in
bfloat16; bfloat16 views in float8 e4m3, float32 views in bfloat16; the
net's layers in float8 e4m3 where the configuration runs them in
bfloat16).  ``fault_half_batch``: the reference put in the program's place
with half of its minibatch left out (the mean over the rest)."""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import numpy as np
import torch

from . import world as worldlib
from .reference import dqn as refdqn
from .reference import threefry as tf
from .reference.gridworld import FIELDS, NORTH, World

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LOWER = {"f32": refdqn.bf16, "bf16": refdqn.fp8}
FLOAT_FIELDS = {"hp": "hp_gap", "next_reward": "reward_gap",
                "last_reward": "reward_gap"}


def ref_world(cfg, device, n_envs):
    w = cfg["world"]
    wall, placed = worldlib.layout(w)
    return World(w, n_envs, wall, placed, device)


class Gaps:
    """The largest gap of each number seen so far."""

    def __init__(self, names):
        self.v = {n: 0.0 for n in names}
        self.where = {}  # what read each largest gap, where it is known

    def add(self, name, value, where=None):
        if float(value) > self.v[name] and where is not None:
            self.where[name] = where
        self.v[name] = max(self.v[name], float(value))

    def ints(self, a, b):
        a = torch.as_tensor(np.asarray(a, np.int64) if isinstance(a, np.ndarray)
                            else a)
        b = torch.as_tensor(np.asarray(b, np.int64) if isinstance(b, np.ndarray)
                            else b)
        a = a.to(b.device)
        if a.shape != b.shape:
            self.add("ints_differing", max(a.numel(), b.numel()))
        else:
            self.v["ints_differing"] += float((a.long() != b.long()).sum())

    def floats(self, name, a, b):
        a = a.to(b.device).float()
        if a.shape != b.shape:
            self.add(name, float("inf"))
        elif a.numel():
            gap = (a - b.float()).abs().max()
            self.add(name, float("inf") if gap.isnan() else gap)


def compare_state(gaps, got, want):
    """The fields of ``got`` (a state of the program's, or of the
    reference's in its place) against the reference's ``want``; a
    program's state also has every body facing north and every slot
    active."""
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if f in FLOAT_FIELDS:
            gaps.floats(FLOAT_FIELDS[f], a, b)
        else:
            gaps.ints(a, b)
    for f, v in (("dir", NORTH), ("active", True)):
        if hasattr(got, f):
            t = getattr(got, f)
            gaps.ints(t, torch.full_like(t, v))


def _lowered(s, lower):
    return SimpleNamespace(**dict(vars(s), **{
        f: lower(getattr(s, f).float()) for f in FLOAT_FIELDS}))


# ---------------------------------------------------------------- env cells
ENV_NUMBERS = ("ints_differing", "hp_gap", "reward_gap", "view_gap")


def check_env(loop, cfg, seed, device, control=False):
    """-> ({number: gap} of the program (or, with ``control``, of the
    reference in the lower precision) against the reference, the number of
    steps checked)."""
    gaps = Gaps(ENV_NUMBERS)
    rw = ref_world(cfg, device, loop.n_envs)
    base = tf.seed_key(seed)
    lower_view, lower = LOWER[cfg["obs_dtype"]], refdqn.bf16
    with torch.no_grad():
        if not control:
            compare_state(gaps, loop.reset, rw.reset(tf.fold_in(base, 0)))
        key = tf.fold_in(base, 1)
        for n in range(max(loop.kept, default=-1) + 1):
            halves = tf.split(key)
            key, akey = halves[0], halves[1]
            if n not in loop.kept:
                continue
            k = loop.kept[n]
            s = World.of(k["state"])
            actions = rw.random_actions(akey)
            if control:  # the lower precision in the program's place
                cs = _lowered(s, lower)
                c_next, c_rew, c_alive, c_done = rw.transition(cs, actions)
                got = dict(actions=actions, next=_lowered(c_next, lower),
                           rewards=lower(c_rew), alive=c_alive, done=c_done)
            else:
                got = k
            for g in range(rw.G):
                view, feat = rw.observe(s, g)
                if control:
                    gv, gf = rw.observe(cs, g)
                    gv, gf = lower_view(gv), lower(gf)
                else:
                    gv, gf = got["obs"][g]
                gaps.floats("view_gap", gv, view)
                gaps.floats("view_gap", gf, feat)
                del view, feat, gv, gf
            gaps.ints(got["actions"], actions)
            nxt, rewards, alive, done = rw.transition(s, actions)
            compare_state(gaps, got["next"], nxt)
            gaps.floats("reward_gap", got["rewards"], rewards)
            gaps.ints(got["alive"], alive)
            gaps.ints(got["done"], done)
    return gaps.v, len(loop.kept)


# -------------------------------------------------------------- train cells
TRAIN_NUMBERS = ("ints_differing", "hp_gap", "reward_gap", "greedy_gap",
                 "loss_gap", "grad_gap", "update_gap")
CHUNK = 16384


def q_values(params, view, feat, quant=None):
    n = view.shape[0]
    return torch.cat([refdqn.forward(params, view[i:i + CHUNK],
                                     feat[i:i + CHUNK], quant)
                      for i in range(0, n, CHUNK)]) if n else None


class _Learner:
    """One side of the reference's learner: float32 (``quant`` None), the
    control, or a planted fault, from a start (``params``, ``targets``,
    Adam's ``mu``, ``nu`` and ``count``; per group, by parameter name)."""

    def __init__(self, start, lr, clip, quant=None, fault=None):
        self.p = [{k: v.float().clone().requires_grad_(True) for k, v in g.items()}
                  for g in start["params"]]
        self.t = [{k: v.float().clone() for k, v in g.items()}
                  for g in start["targets"]]
        self.opt = []
        for g in range(len(self.p)):
            o = refdqn.Adam(self.p[g], lr, clip)
            o.count = start["count"][g]
            o.mu = {k: v.float().clone() for k, v in start["mu"][g].items()}
            o.nu = {k: v.float().clone() for k, v in start["nu"][g].items()}
            self.opt.append(o)
        self.quant, self.fault = quant, fault
        self.losses, self.mu1 = [], [None] * len(self.p)


def _norm_gap(got, want, keep=None):
    """The worst leaf's gap of norms: ``| |got| - |want| |`` over the larger
    of the leaf's reference norm and the median leaf's -> (gap, leaf)."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    med = statistics.median(norms.values())
    worst = (0.0, None)
    for k, w in want.items():
        if keep is not None and k not in keep:
            continue
        gap = abs(float(got[k].float().norm()) - norms[k]) / max(norms[k], med, 1e-30)
        worst = max(worst, (gap, k), key=lambda t: t[0])
    return worst


def check_train(loop, cfg, traffic, seed, device, sides=("program",)):
    """-> {side: {number: gap}}: ``program`` judges the program's recorded
    train steps, those of set-up's first call and of the call after the
    window; ``control`` and ``fault_half_batch`` put the reference in the
    lower precision, or with half its minibatch left out (the mean over
    the rest), in the program's place, on set-up's steps."""
    gaps = {s: Gaps(TRAIN_NUMBERS) for s in sides}
    rw = ref_world(cfg, device, loop.n_envs)
    base = tf.seed_key(seed)
    with refdqn.exact_float32():
        with torch.no_grad():
            state = rw.reset(tf.fold_in(base, 0))
        if "program" in sides:
            compare_state(gaps["program"], loop.reset, state)
        follow(rw, cfg, traffic, state, loop.records[0], base, gaps, sides)
        if len(loop.records) > 1 and "program" in sides:
            rec = loop.records[1]
            carried(gaps["program"], rw, traffic, rec, base)
            follow(rw, cfg, traffic, World.of(rec["state"]), rec, base, gaps,
                   ("program",))
    loop.where = gaps["program"].where if "program" in gaps else {}
    return {s: gaps[s].v for s in sides}


def carried(gaps, rw, traffic, rec, base):
    """What the calls before ``rec``'s carried into it: every env ``n`` =
    (calls x train steps x rollout) steps on from its reset, with its key
    split ``n`` times over, and each group's Adam count at the train steps
    taken.  No battle of the configurations ends in the steps a run
    reaches, so no env has started afresh."""
    spc = int(traffic["steps_per_call"])
    n = rec["call"] * spc * int(traffic["rollout"])
    s = World.of(rec["state"])
    gaps.ints(s.step_ct, torch.full_like(s.step_ct, n))
    key = rw.reset(tf.fold_in(base, 0)).key
    for _ in range(n):
        key = tf.split(key)[:, 0]
    gaps.ints(s.key, key)
    gaps.ints(torch.tensor(rec["start"]["count"]),
              torch.full((rw.G,), rec["call"] * spc))


def follow(rw, cfg, traffic, state, rec, base, gaps, sides):
    """The reference follows the program's recorded train steps ``rec``
    (from call ``rec["call"]``, whose start is ``rec["start"]``) from the
    env state ``state``."""
    t = traffic
    T, K, eps = int(t["rollout"]), int(t["train_minibatch"]), float(t["eps"])
    gamma, n_checked = float(t["gamma"]), rec["checked"]
    lower = LOWER[cfg["net"]["dtype"]]
    view_dtype = DTYPES[cfg["obs_dtype"]]
    B, G = rw.B, rw.G
    start = rec["start"]
    ref = _Learner(start, t["lr"], t["clip"])
    others = {s: _Learner(start, t["lr"], t["clip"],
                          quant=lower if s == "control" else None,
                          fault=s if s.startswith("fault") else None)
              for s in sides if s != "program"}
    key = tf.fold_in(tf.fold_in(base, 1), rec["call"])
    steps = iter(rec["transitions"])
    for step in range(n_checked):
        key, skey = tf.split(key)
        lkey, rkey = tf.split(skey)
        traj = dict(views=[[] for _ in range(G)], feats=[[] for _ in range(G)],
                    actions=[], rewards=[], alive=[], done=[], alive_in=[])
        with torch.no_grad():
            for _ in range(T):
                rkey, akey = tf.split(rkey)
                p_act, p_next, p_rew, p_alive, p_done = next(steps)
                p_act = p_act.to(rw.device)
                traj["alive_in"].append(~state.dead)
                for g in range(G):
                    o, cap = rw.offsets[g], rw.caps[g]
                    view, feat = rw.observe(state, g)
                    view = view.to(view_dtype)
                    traj["views"][g].append(view)
                    traj["feats"][g].append(feat)
                    n_act = rw.types[g].n_action
                    kg, kr = tf.split(tf.fold_in(akey, g))
                    rand = torch.as_tensor(tf.randint(kg, (B, cap), 0, n_act),
                                           device=rw.device)
                    explore = torch.as_tensor(tf.uniform(kr, (B, cap)) < eps,
                                              device=rw.device)
                    rows = (view.reshape((-1,) + tuple(view.shape[2:])),
                            feat.reshape(B * cap, -1))
                    q = q_values(ref.p[g], *rows).reshape(B, cap, n_act)
                    best = q.max(-1).values
                    for side in sides:
                        if side == "program":
                            act = p_act[:, o:o + cap]
                        else:
                            s_ = others[side]
                            qo = q_values(s_.p[g], *rows, s_.quant)
                            act = torch.where(explore, rand, qo.reshape(
                                B, cap, n_act).argmax(-1).to(torch.int32))
                        gp = gaps[side]
                        gp.ints(act[explore], rand[explore])
                        taken = q.gather(-1, act.long()[..., None])[..., 0]
                        if (~explore).any():
                            gp.add("greedy_gap", (best - taken)[~explore].max(),
                                   "call %d group %d" % (rec["call"], g))
                nxt, rew, alive, done = rw.transition(state, p_act)
                if "control" in sides:  # the env in the lower precision
                    c_nxt, c_rew = rw.transition(_lowered(state, refdqn.bf16),
                                                 p_act)[:2]
                    compare_state(gaps["control"], _lowered(c_nxt, refdqn.bf16),
                                  nxt)
                    gaps["control"].floats("reward_gap", refdqn.bf16(c_rew), rew)
                if "program" in sides:
                    gp = gaps["program"]
                    compare_state(gp, p_next, nxt)
                    gp.floats("reward_gap", p_rew, rew)
                    gp.ints(p_alive, alive)
                    gp.ints(p_done, done)
                for name, v in (("actions", p_act), ("rewards", rew),
                                ("alive", alive), ("done", done)):
                    traj[name].append(v)
                state = nxt
        _learn(rw, K, T, gamma, lkey, traj, ref, others)
        del traj
        if "program" in sides:
            p_loss = rec["loss"][step].float()
            for g in range(G):
                r = ref.losses[-1][g]
                gaps["program"].add("loss_gap", abs(float(p_loss[g]) - r) / abs(r),
                                    "call %d step %d group %d" % (rec["call"], step, g))
        for side, o in others.items():
            for g in range(G):
                r = ref.losses[-1][g]
                gaps[side].add("loss_gap", abs(o.losses[-1][g] - r) / abs(r))
    for g in range(G):
        names = list(start["params"][g])
        mu0 = start["mu"][g]

        def grad(mu1):  # the first step's clipped gradient, from Adam's mu
            return {k: (mu1[k].float() - refdqn.B1 * mu0[k].float()) / (1 - refdqn.B1)
                    for k in names}

        g1 = grad(ref.mu1[g])
        med = statistics.median(float(v.norm()) for v in g1.values())
        moving = {k for k, v in g1.items() if float(v.norm()) >= 1e-3 * med}
        p0 = {k: start["params"][g][k].float() for k in names}
        d_ref = {k: ref.p[g][k].detach() - p0[k] for k in names}
        for side in sides:
            if side == "program":
                mu1, after = rec["mu1"][g], rec["params"][g]
            else:
                mu1, after = others[side].mu1[g], {
                    k: v.detach() for k, v in others[side].p[g].items()}
            gp = gaps[side]
            if rec["call"] == 0:
                # the first gradient; later calls' value-head bias, a mean
                # of TD errors that cancel, swings with the bf16 net's
                # rounding (PERF.md, section 2)
                gap, leaf = _norm_gap(grad(mu1), g1)
                gp.add("grad_gap", gap, "call %d group %d %s" % (rec["call"], g, leaf))
            gap, leaf = _norm_gap({k: after[k].float() - p0[k] for k in names},
                                  d_ref, moving)
            gp.add("update_gap", gap, "call %d group %d %s" % (rec["call"], g, leaf))


def _learn(rw, K, T, gamma, lkey, traj, ref, others):
    """One learner step of every side on the reference's trajectory.  The
    fault ``fault_half_batch`` leaves out half of the minibatch (the mean
    over the rest)."""
    B = rw.B
    acts = torch.stack(traj["actions"])
    rews = torch.stack(traj["rewards"])
    term_all = ~torch.stack(traj["alive"]) | torch.stack(traj["done"])[:, :, None]
    prev_all = torch.stack(traj["alive_in"])
    sides = [ref] + list(others.values())
    for side in sides:
        side.losses.append([])
    for g in range(rw.G):
        o, cap = rw.offsets[g], rw.caps[g]
        sl = slice(o, o + cap)
        view = torch.stack(traj["views"][g])
        feat = torch.stack(traj["feats"][g])
        flat_v = view.reshape((T * B * cap,) + tuple(view.shape[3:]))
        flat_f = feat.reshape(T * B * cap, -1)
        act = acts[..., sl].reshape(-1).long()
        rew = rews[..., sl].reshape(-1)
        term = term_all[..., sl].reshape(-1)
        prev = prev_all[..., sl].reshape(-1)
        cur = torch.as_tensor(tf.randint(tf.fold_in(lkey, 1000 + g), (K,), 0,
                                         (T - 1) * B * cap),
                              device=rw.device).long()
        nxt = cur + B * cap
        for side in sides:
            c, nx = cur, nxt
            if side.fault == "fault_half_batch":
                c, nx = cur[: K // 2], nxt[: K // 2]
            loss = refdqn.td_loss(side.p[g], side.t[g], flat_v[c], flat_f[c],
                                  act[c], flat_v[nx], flat_f[nx], rew[c],
                                  term[c], prev[c], gamma, side.quant)
            names = list(side.p[g])
            grads = torch.autograd.grad(loss, [side.p[g][k] for k in names])
            first = side.mu1[g] is None
            side.opt[g].step(side.p[g], dict(zip(names, grads)))
            side.losses[-1].append(float(loss.detach()))
            if first:
                side.mu1[g] = {k: v.clone() for k, v in side.opt[g].mu.items()}
        del view, feat, flat_v, flat_f
