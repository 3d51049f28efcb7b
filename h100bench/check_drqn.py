"""The comparison that decides ``correct`` for ``drqn_train`` cells: the
program's recorded DRQN train steps against the plain reference
(:mod:`h100bench.reference.drqn`), after the window, in the pattern of
:func:`h100bench.check.check_train`.

Twice: set-up's first train steps (``checked_steps``; they may run over
more than one call), which the reference follows from its own reset, the
nets' initial weights and zero GRU states; and the first train steps of
the call after the window (``checked_steps_after``), which it follows
from the program's state when that call began (env, nets, target nets,
Adam moments and count, and the GRU state of every agent slot), after
checking that what the calls before it carried (step counters, keys,
Adam's count) is that many steps on.  In each it draws the exploration
itself, judges each greedy action by its own Q values, carries its own
GRU state (zeroed where an agent died or its episode ended), steps its
own env with the program's actions and takes the window's TD loss, its
gradient through time and the Adam step in float32, over blocks of
agents whose sums add up to the batch's.

The numbers are :mod:`h100bench.check`'s and ``hidden_gap``: the largest
absolute gap between the program's carried GRU state (float32) and the
reference's at the end of each call the reference followed whole.

Sides besides ``program``: ``control``, the reference with every layer
but the heads in float8 e4m3 (the precision below the configuration's
bfloat16) in the program's place, its env's hp and rewards in bfloat16;
and planted faults, the reference in the program's place with one part
broken: ``fault_no_reset`` (the state is not zeroed after a death or an
episode's end), ``fault_bptt_cut`` (the state is detached at each frame
of the learner's unroll) and ``fault_target_zero`` (the target net
re-unrolls the window from zero states)."""

from __future__ import annotations

import statistics

import torch

from . import check
from .check import Gaps, _Learner, _lowered, _norm_gap, compare_state
from .reference import dqn as refdqn
from .reference import drqn as refdrqn
from .reference import threefry as tf
from .reference.gridworld import World

NUMBERS = ("ints_differing", "hp_gap", "reward_gap", "greedy_gap",
           "hidden_gap", "loss_gap", "grad_gap", "update_gap")
BLOCK = 16384


class _Side(_Learner):
    """A side's nets, Adam state and GRU states (``h``, per group, one row
    per agent slot of every world)."""

    def __init__(self, start, lr, clip, quant=None, fault=None):
        super().__init__(start, lr, clip, quant, fault)
        self.h = [h.float().reshape(-1, h.shape[-1]).clone()
                  for h in start["hiddens"]]


def _acting(p, h, view, feat, quant):
    """One agent step of ``N`` agents in blocks, without gradient -> (new
    states, Q values)."""
    hs, qs = [], []
    with torch.no_grad():
        for i in range(0, view.shape[0], BLOCK):
            h2, q = refdrqn.step(p, h[i:i + BLOCK], view[i:i + BLOCK],
                                 feat[i:i + BLOCK], quant)
            hs.append(h2)
            qs.append(q)
    return torch.cat(hs), torch.cat(qs)


def check_drqn(loop, cfg, traffic, seed, device, sides=("program",)):
    """-> {side: {number: gap}}: ``program`` judges the program's recorded
    train steps (set-up's, then the call after the window's); the other
    sides are the reference in the program's place, on set-up's steps."""
    gaps = {s: Gaps(NUMBERS) for s in sides}
    rw = check.ref_world(cfg, device, loop.n_envs)
    base = tf.seed_key(seed)
    with refdqn.exact_float32():
        with torch.no_grad():
            state = rw.reset(tf.fold_in(base, 0))
        if "program" in sides:
            compare_state(gaps["program"], loop.reset, state)
        follow(rw, cfg, traffic, state, loop.records[0], base, gaps, sides)
        if len(loop.records) > 1 and "program" in sides:
            rec = loop.records[1]
            check.carried(gaps["program"], rw, traffic, rec, base)
            follow(rw, cfg, traffic, World.of(rec["state"]), rec, base, gaps,
                   ("program",))
    loop.where = gaps["program"].where if "program" in gaps else {}
    return {s: gaps[s].v for s in sides}


def follow(rw, cfg, traffic, state, rec, base, gaps, sides):
    """The reference follows the program's recorded train steps ``rec``
    (from call ``rec["call"]``, whose start is ``rec["start"]``) from the
    env state ``state``."""
    t = traffic
    T, eps, gamma = int(t["rollout"]), float(t["eps"]), float(t["gamma"])
    spc, n_checked = int(t["steps_per_call"]), rec["checked"]
    target_update = int(t["target_update"])
    lower = check.LOWER[cfg["net"]["dtype"]]
    view_dtype = check.DTYPES[cfg["obs_dtype"]]
    B, G = rw.B, rw.G
    start = rec["start"]
    ref = _Side(start, t["lr"], t["clip"])
    others = {s: _Side(start, t["lr"], t["clip"],
                       quant=lower if s == "control" else None,
                       fault=s if s.startswith("fault") else None)
              for s in sides if s != "program"}
    everyone = [ref] + list(others.values())
    steps = iter(rec["transitions"])
    for step in range(n_checked):
        call = rec["call"] + step // spc
        if step % spc == 0:
            key = tf.fold_in(tf.fold_in(base, 1), call)
        key, skey = tf.split(key)
        rkey = tf.split(skey)[1]
        h0 = {id(s): [h.clone() for h in s.h] for s in everyone}
        traj = dict(views=[[] for _ in range(G)], feats=[[] for _ in range(G)],
                    actions=[], rewards=[], alive=[], done=[], alive_in=[])
        with torch.no_grad():
            for _ in range(T):
                rkey, akey = tf.split(rkey)
                p_act, p_next, p_rew, p_alive, p_done = next(steps)
                p_act = p_act.to(rw.device)
                traj["alive_in"].append(~state.dead)
                new_h = {}
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
                    h2, q = _acting(ref.p[g], ref.h[g], *rows, None)
                    new_h[id(ref), g] = h2
                    q = q.reshape(B, cap, n_act)
                    best = q.max(-1).values
                    for side in sides:
                        if side == "program":
                            act = p_act[:, o:o + cap]
                        else:
                            s_ = others[side]
                            h2o, qo = _acting(s_.p[g], s_.h[g], *rows, s_.quant)
                            new_h[id(s_), g] = h2o
                            act = torch.where(explore, rand, qo.reshape(
                                B, cap, n_act).argmax(-1).to(torch.int32))
                        gp = gaps[side]
                        gp.ints(act[explore], rand[explore])
                        taken = q.gather(-1, act.long()[..., None])[..., 0]
                        if (~explore).any():
                            gp.add("greedy_gap", (best - taken)[~explore].max(),
                                   "call %d step %d group %d" % (call, step, g))
                nxt, rew, alive, done = rw.transition(state, p_act)
                for s in everyone:
                    for g in range(G):
                        o, cap = rw.offsets[g], rw.caps[g]
                        keep = (alive[:, o:o + cap] & ~done[:, None]).reshape(-1)
                        if s.fault == "fault_no_reset":
                            keep = torch.ones_like(keep)
                        s.h[g] = torch.where(keep[:, None], new_h[id(s), g], 0.0)
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
        _learn(rw, gamma, traj, h0, everyone)
        del traj
        if (step + 1) % spc == 0:  # a call followed whole: its states
            c = step // spc
            for side in sides:
                s_ = others.get(side)
                got = rec["hiddens"][c] if s_ is None else s_.h
                for g in range(G):
                    gaps[side].add("hidden_gap", (got[g].reshape(-1).to(
                        rw.device).float() - ref.h[g].reshape(-1)).abs().max(),
                        "call %d group %d" % (call, g))
        if (rec["call"] * spc + step + 1) % target_update == 0:
            for s in everyone:
                s.t = [{k: v.detach().clone() for k, v in p.items()} for p in s.p]
        if "program" in sides:
            p_loss = rec["loss"][step].float()
            for g in range(G):
                r = ref.losses[-1][g]
                gaps["program"].add("loss_gap", abs(float(p_loss[g]) - r) / abs(r),
                                    "call %d step %d group %d" % (call, step, g))
        for side, o in others.items():
            for g in range(G):
                r = ref.losses[-1][g]
                gaps[side].add("loss_gap", abs(o.losses[-1][g] - r) / abs(r))
    _param_gaps(rec, ref, others, gaps, sides)


def _learn(rw, gamma, traj, h0, everyone):
    """One learner step of every side on the reference's window, from the
    GRU states ``h0`` the window started in: the TD loss over every agent
    and frame, its gradient through time, and the Adam step; the loss and
    the gradient summed over blocks of agents."""
    B = rw.B
    acts = torch.stack(traj["actions"])
    rews = torch.stack(traj["rewards"])
    alive_all = torch.stack(traj["alive"])
    done_all = torch.stack(traj["done"])[:, :, None]
    prev_all = torch.stack(traj["alive_in"])
    for side in everyone:
        side.losses.append([])
    for g in range(rw.G):
        o, cap = rw.offsets[g], rw.caps[g]
        sl = slice(o, o + cap)
        T = len(traj["views"][g])
        view = torch.stack(traj["views"][g])
        view = view.reshape((T, B * cap) + tuple(view.shape[3:]))
        feat = torch.stack(traj["feats"][g]).reshape(T, B * cap, -1)
        act = acts[..., sl].reshape(T, -1)
        rew = rews[..., sl].reshape(T, -1)
        term = (~alive_all[..., sl] | done_all).reshape(T, -1)
        prev = prev_all[..., sl].reshape(T, -1)
        keep = (alive_all[..., sl] & ~done_all).reshape(T, -1)
        denom = prev[:-1].float().sum().clamp_min(1.0)
        N = B * cap
        for side in everyone:
            names = list(side.p[g])
            grads = [torch.zeros_like(side.p[g][k]) for k in names]
            loss = 0.0
            for i in range(0, N, BLOCK):
                b = slice(i, i + BLOCK)
                hs = h0[id(side)][g][b]
                args = (view[:, b], feat[:, b], keep[:, b], side.quant)
                with torch.no_grad():
                    th = (torch.zeros_like(hs) if side.fault == "fault_target_zero"
                          else hs)
                    tqs = refdrqn.unroll(side.t[g], th, *args)[0]
                qs = refdrqn.unroll(side.p[g], hs, *args,
                                    cut=side.fault == "fault_bptt_cut")[0]
                total = refdrqn.td_sum(qs, tqs, act[:, b], rew[:, b],
                                       term[:, b], prev[:, b], gamma)[0]
                part = total / denom
                for acc, gr in zip(grads, torch.autograd.grad(
                        part, [side.p[g][k] for k in names])):
                    acc += gr
                loss += float(part.detach())
                del qs, tqs, part, total
            first = side.mu1[g] is None
            side.opt[g].step(side.p[g], dict(zip(names, grads)))
            side.losses[-1].append(loss)
            if first:
                side.mu1[g] = {k: v.clone() for k, v in side.opt[g].mu.items()}
        del view, feat


def _param_gaps(rec, ref, others, gaps, sides):
    """``grad_gap`` (set-up's first step) and ``update_gap`` of each side,
    by the worst leaf, as :func:`h100bench.check.follow` takes them."""
    start = rec["start"]
    for g in range(len(ref.p)):
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
                gap, leaf = _norm_gap(grad(mu1), g1)
                gp.add("grad_gap", gap, "call %d group %d %s" % (rec["call"], g, leaf))
            gap, leaf = _norm_gap({k: after[k].float() - p0[k] for k in names},
                                  d_ref, moving)
            gp.add("update_gap", gap, "call %d group %d %s" % (rec["call"], g, leaf))
