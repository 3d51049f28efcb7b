"""Fused rollout + learner steps (port of ``magent_tpu/parallel/train.py``):
DQN (whole-rollout, minibatch and observation-remat losses), A2C (with
optional CommNet) and DRQN.

A train step rolls ``rollout_len`` lockstep env steps with the current
policies, then takes one gradient step per group, with everything on the
env's device.  Where the JAX package passes flax modules (``nets``) and
their parameter pytrees (``params``), the port passes one net of
:mod:`magent_tpu_torch.builtin.torch_model` per group (``DQNNet``,
``A2CNet``, ``DRQNNet``), module and parameters in one: a train step
updates the online nets in place and returns them, the loop refreshes
the target nets in place
(``load_state_dict``) where the JAX loop selects new target params, and
``tx`` is a :class:`~magent_tpu_torch.parallel.optim.ClipAdam` whose
per-group states (``tx.init(net)``) play optax's.  Each group needs a
module of its own (and a separate target copy): the groups train
independently, as in the JAX package.

Keys are the port's int64 ``[2]`` threefry keys (:mod:`magent_tpu_torch.random`),
bit-equal to ``jax.random``'s, so a step from the same key draws the same
actions and minibatch as the JAX step (A2C's categorical draw: the same
Gumbel bits, ``log`` in PyTorch's rounding).  Metrics stay on the device,
stacked per call; the only host reads inside a step are the env's
auto-reset checks (one per env step, ``VecGridWorld.transition``).  Python
loops take the place of ``lax.scan``; the env runs under
``torch.no_grad`` and only the nets under autograd.  Each step's rollout
and learn halves run on cuDNN's deterministic convolutions
(:func:`~magent_tpu_torch.builtin.torch_model.base.deterministic_convolutions`):
without them an f32 step's convolution gradients sum in an order that
varies run to run on the card, so one key gave different parameters.

Data parallelism (:mod:`.sharding`): with a venv on a mesh, each ``dp``
rank rolls out its own env rows and every draw is made at the global
batch and sliced, so the ranks act as the unsharded step does on their
rows.  A loss is this rank's sum over the global count (the counts are
all-reduced), and the gradients are summed over the venv's ``dp`` before
the optimizer's step (:func:`_apply`): the gradient of the global loss,
which JAX's single program computes with XLA's inserted ``psum``.  The
mesh of the venv alone decides both reductions, so a net that is not
placed (its parameters replicated on every rank) trains as a placed one
does.  The metrics are global.  Tensor parallelism lives in the nets
(:func:`.sharding.linear`).  Without a mesh, or at world size 1, no
collective runs and every value is the unsharded step's.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import random as rnd
from ..builtin.torch_model.base import deterministic_convolutions
from ..builtin.torch_model.drqn import split_unroll
from .sharding import all_reduce_flat, sum_dp
from .vec_env import VecGridWorld

# the state fields the observation reads: what the remat trainer stores per
# step (train.py:353-354)
OBS_FIELDS = ("x", "y", "hp", "dir", "active", "dead", "absorbed", "id",
              "last_action", "last_reward")


def _groups(venv: VecGridWorld, train_groups):
    return (set(range(venv.spec.n_groups)) if train_groups is None
            else set(train_groups))


def _rows(view, feat):
    """Views ``[..., vh, vw, C]`` and features ``[..., F]`` -> one row per
    agent: ``[N, vh, vw, C]``, ``[N, F]``."""
    return (view.reshape((-1,) + tuple(view.shape[-3:])),
            feat.reshape(-1, feat.shape[-1]))


def _global_mean(venv: VecGridWorld, t):
    """The mean of the per-env-row tensor ``t`` over every rank's rows."""
    if venv.n_local == venv.n_envs:
        return t.mean()
    return sum_dp(t.sum(), venv.mesh) / (t.numel() * venv.n_envs
                                         // venv.n_local)


def _egreedy_actions(venv: VecGridWorld, nets, state, key, eps,
                     train_groups=None):
    """(e-greedy actions ``[B, A]`` int32 for every group over the full slot
    axis (train.py:20-69), the rendered views and features per group).
    Groups outside ``train_groups`` act uniformly at random and render
    nothing (scripted opponents)."""
    spec = venv.spec
    B, A = venv.n_local, spec.n_agents_cap
    tg = _groups(venv, train_groups)
    actions = torch.zeros((B, A), dtype=torch.int32, device=venv.device)
    views, feats = [], []
    if train_groups is None:
        all_obs = venv.observe_all(state)
    else:  # render only the policy groups, sharing one grid pass
        grids = venv._grids(state) if venv._grids is not None else None
        all_obs = [venv.observe(state, g, grids) if g in tg else None
                   for g in range(spec.n_groups)]
    for g, gs in enumerate(spec.groups):
        n_act = gs.type.n_action
        sl = slice(gs.offset, gs.offset + gs.cap)
        if g not in tg:
            kg = rnd.split(rnd.fold_in(key, g))[..., 0, :]
            actions[:, sl] = venv.local_rows(
                rnd.randint(kg, (venv.n_envs, gs.cap), 0, n_act))
            views.append(None)
            feats.append(None)
            continue
        view, feat = all_obs[g]  # [B, cap, vh, vw, C], [B, cap, F]
        with torch.no_grad():
            q = nets[g](*_rows(view, feat)).reshape(B, gs.cap, n_act)
        actions[:, sl] = _egreedy(q, rnd.fold_in(key, g), eps, venv)
        views.append(view)
        feats.append(feat)
    return actions, views, feats


def _egreedy(q, gkey, eps, venv: VecGridWorld):
    """e-greedy actions int32 of Q values ``[B, cap, n_act]`` of ``venv``'s
    rows from one group's key (``fold_in(akey, g)``): ``randint`` from its
    first half where ``uniform`` from its second falls below ``eps``, else
    the argmax; both drawn at the global batch."""
    kg, kr = rnd.split(gkey).unbind(-2)
    greedy = q.argmax(-1).to(torch.int32)
    shape = (venv.n_envs,) + tuple(greedy.shape[1:])
    rand = venv.local_rows(rnd.randint(kg, shape, 0, q.shape[-1]))
    explore = venv.local_rows(rnd.uniform(kr, shape)) < eps
    return torch.where(explore, rand, greedy)


def sample_eval_set(venv: VecGridWorld, group: int, n_steps: int = 10,
                    key=None):
    """A fixed set of evaluation observations for ``group`` from a random
    rollout (train.py:72-104; the reference's sample_observation, utility.py:
    115-178): reset from ``fold_in(key, 0)``, then ``n_steps`` of observe ->
    random actions -> transition.  -> (views [n_steps*B*cap, vh, vw, C],
    feats [n_steps*B*cap, F]).  ``key`` defaults to ``PRNGKey(1234)``."""
    key = (rnd.PRNGKey(1234) if key is None else key).to(venv.device)
    state = venv.reset(rnd.fold_in(key, 0))
    views, feats = [], []
    with torch.no_grad():
        for _ in range(n_steps):
            key, akey = rnd.split(key).unbind(-2)
            view, feat = venv.observe(state, group)
            state = venv.transition(state, venv.random_actions(akey))[0]
            views.append(view)
            feats.append(feat)
    return (torch.stack(views).reshape((-1,) + tuple(views[0].shape[2:])),
            torch.stack(feats).reshape(-1, feats[0].shape[-1]))


def make_eval_q(venv: VecGridWorld, group: int):
    """``eval_q(nets, views, feats) -> mean max-Q`` of ``nets[group]`` on a
    fixed eval set (train.py:107-116; pair with :func:`sample_eval_set`),
    a 0-d tensor on the device.  Pass the online or the target nets."""
    def eval_q(nets, views, feats):
        with torch.no_grad():
            # on a mesh: every rank's eval rows (the same count on each)
            return _global_mean(venv, nets[group](views, feats).max(-1)
                                .values)

    return eval_q


def _rollout(venv: VecGridWorld, act, env_state, key, rollout_len,
             store_obs):
    """``rollout_len`` steps under ``torch.no_grad``, each drawing its
    actions from ``act(state, akey) -> (actions [B, A], views, feats)`` ->
    (env_state, per-step records stacked on a leading T axis).
    ``store_obs`` keeps each group's views and features (the plain
    trainers' trajectory); the remat trainer keeps the compact
    ``OBS_FIELDS`` snapshots instead."""
    steps = []
    with torch.no_grad():
        for _ in range(rollout_len):
            key, akey = rnd.split(key).unbind(-2)
            state = env_state
            # start-of-step liveness: right across auto-resets, where the
            # last step's end-of-step alive belongs to the old episode
            rec = dict(alive_in=state.active & ~state.dead)
            actions, views, feats = act(state, akey)
            if store_obs:
                rec.update(views=views, feats=feats)
            else:
                rec["snap"] = {f: getattr(state, f) for f in OBS_FIELDS}
            env_state, rewards, alive, done = venv.transition(state, actions)
            rec.update(actions=actions, rewards=rewards, alive=alive,
                       done=done)
            steps.append(rec)
    return env_state, _stack_steps(steps, venv.spec.n_groups)


def _stack_steps(steps, n_groups):
    """Per-step records -> one tensor per field on a leading T axis (per
    group for views, features and Q values; None for a group that
    rendered nothing)."""
    def stack(get):
        return torch.stack([get(r) for r in steps])

    traj = {}
    for name in steps[0]:
        if name == "snap":
            traj[name] = {f: stack(lambda r, f=f: r[name][f])
                          for f in OBS_FIELDS}
        elif isinstance(steps[0][name], list):
            traj[name] = [None if steps[0][name][g] is None else
                          stack(lambda r, n=name, g=g: r[n][g])
                          for g in range(n_groups)]
        else:
            traj[name] = stack(lambda r, n=name: r[n])
    return traj


def _td_loss(q_t, next_v, rew, terminal, mask, gamma):
    """Masked TD(0) loss sum and mask sum: ``target`` is ``rew`` where
    terminal, else ``rew + gamma * next_v`` (no gradient through either)."""
    target = torch.where(terminal, rew, rew + gamma * next_v.detach())
    mask = mask.to(torch.float32)
    return ((target - q_t).square() * mask).sum(), mask.sum()


def _next_value(net, tnet, view, feat, use_double):
    """The TD target's next-state value: the target net's Q at the online
    net's argmax (double DQN), or its max; no gradient."""
    with torch.no_grad():
        tq = tnet(view, feat)
        if not use_double:
            return tq.max(-1).values
        sel = net(view, feat).argmax(-1, keepdim=True)
        return tq.gather(-1, sel)[..., 0]


def _apply(net, tx, opt_state, loss, mesh):
    """Backward, the gradients summed over ``mesh``'s ``dp`` (``loss`` is
    this rank's part of the global loss; the ranks of one ``tp`` group
    hold the same env rows), and one ``tx`` step on ``net`` in place ->
    new state."""
    net.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None and mesh.groups["dp"] is not None:
        params = list(net.parameters())
        for p, g in zip(params, all_reduce_flat([p.grad for p in params],
                                                mesh, "dp")):
            p.grad = g
    return tx.update(net, opt_state)


def _group_slicer(spec):
    offs = [g.offset for g in spec.groups]
    caps = [g.cap for g in spec.groups]

    def group_slice(t, g):
        return t[..., offs[g]:offs[g] + caps[g]]

    return group_slice


def make_dqn_train_step(venv: VecGridWorld, tx, gamma: float = 0.99,
                        rollout_len: int = 8, use_double: bool = True,
                        train_minibatch: int | None = None,
                        train_groups=None):
    """Build ``train_step(nets, target_nets, opt_states, env_state, key,
    eps) -> (nets, opt_states, env_state, metrics)`` (train.py:119-322).

    One call rolls ``rollout_len`` steps, then takes one double-DQN
    gradient step per trained group on the collected transitions (TD(0)
    over consecutive rollout steps, masked by start-of-step liveness).
    ``train_minibatch``: train on that many uniformly sampled transitions
    (``group_loss_sampled``) instead of all ``(rollout_len - 1) * B * cap``
    (``group_loss``).  ``train_groups``: the groups that act with their nets
    and train; the others act at random, render nothing and keep their
    nets (loss 0).  ``metrics``: ``loss`` and ``mean_reward``, ``[G]`` f32
    on the device.  ``train_step.rollout`` and ``train_step.learn`` are its
    two halves."""
    spec = venv.spec
    G, B = spec.n_groups, venv.n_local
    caps = [g.cap for g in spec.groups]
    tg = _groups(venv, train_groups)
    group_slice = _group_slicer(spec)
    mesh = venv.mesh

    def group_loss_sampled(net, tnet, g, traj, skey):
        """Double-DQN TD loss on ``train_minibatch`` sampled transitions
        (train.py:197-247)."""
        cap = caps[g]
        view, feat = traj["views"][g], traj["feats"][g]  # [T, B, cap, ...]
        T = view.shape[0]
        vshape = tuple(view.shape[3:])
        flat_v = view.reshape(T * B * cap, -1)
        flat_f = feat.reshape(T * B * cap, -1)
        act = group_slice(traj["actions"], g).reshape(-1)
        rew = group_slice(traj["rewards"], g).reshape(-1)
        term = (~group_slice(traj["alive"], g)
                | traj["done"][:, :, None]).reshape(-1)
        prev = group_slice(traj["alive_in"], g).reshape(-1)

        K = train_minibatch
        cur = rnd.randint(skey, (K,), 0, (T - 1) * venv.n_envs * cap).long()
        if B != venv.n_envs:
            # the draws that fall in this rank's env rows, renumbered
            t, rest = cur // (venv.n_envs * cap), cur % (venv.n_envs * cap)
            b = rest // cap - venv.env_rows[0]
            mine = (b >= 0) & (b < B)
            cur = ((t * B + b) * cap + rest % cap)[mine]
            K = cur.shape[0]
        nxt = cur + B * cap  # the same (env, agent) one step later

        def rows(ix):
            return flat_v.index_select(0, ix).reshape((K,) + vshape), \
                flat_f.index_select(0, ix)

        q_t = net(*rows(cur)).gather(1, act[cur].long()[:, None])[:, 0]
        next_v = _next_value(net, tnet, *rows(nxt), use_double)
        total, denom = _td_loss(q_t, next_v, rew[cur], term[cur], prev[cur],
                                gamma)
        return total / sum_dp(denom, mesh).clamp_min(1.0)

    def group_loss(net, tnet, g, traj):
        """Masked double-DQN TD loss over the whole rollout
        (train.py:249-288)."""
        n_act = spec.groups[g].type.n_action
        view, feat = traj["views"][g], traj["feats"][g]
        T = view.shape[0]
        flat_v, flat_f = _rows(view, feat)
        q_all = net(flat_v, flat_f).reshape(T, B, caps[g], n_act)
        with torch.no_grad():
            tq_all = tnet(flat_v, flat_f).reshape(T, B, caps[g], n_act)
            if use_double:
                sel = q_all[1:].argmax(-1, keepdim=True)
                next_v = tq_all[1:].gather(-1, sel)[..., 0]
            else:
                next_v = tq_all[1:].max(-1).values
        act = group_slice(traj["actions"], g)
        q_t = q_all[:-1].gather(-1, act[:-1].long()[..., None])[..., 0]
        terminal = (~group_slice(traj["alive"], g)[:-1]
                    | traj["done"][:-1][:, :, None])
        total, denom = _td_loss(q_t, next_v,
                                group_slice(traj["rewards"], g)[:-1],
                                terminal,
                                group_slice(traj["alive_in"], g)[:-1], gamma)
        return total / sum_dp(denom, mesh).clamp_min(1.0)

    @deterministic_convolutions()
    def rollout(nets, env_state, key, eps):
        def act(state, akey):
            return _egreedy_actions(venv, nets, state, akey, eps,
                                    train_groups)
        return _rollout(venv, act, env_state, key, rollout_len,
                        store_obs=True)

    @deterministic_convolutions()
    def learn(nets, target_nets, opt_states, traj, key):
        opt_states = list(opt_states)
        zero = torch.zeros((), device=venv.device)
        losses = []
        for g in range(G):
            if g not in tg:  # scripted group: net untouched
                losses.append(zero)
                continue
            if train_minibatch is not None:
                loss = group_loss_sampled(nets[g], target_nets[g], g, traj,
                                          rnd.fold_in(key, 1000 + g))
            else:
                loss = group_loss(nets[g], target_nets[g], g, traj)
            opt_states[g] = _apply(nets[g], tx, opt_states[g], loss, mesh)
            losses.append(sum_dp(loss.detach(), mesh))
        metrics = dict(loss=torch.stack(losses), mean_reward=torch.stack(
            [_global_mean(venv, group_slice(traj["rewards"], g))
             for g in range(G)]))
        return tuple(opt_states), metrics

    def train_step(nets, target_nets, opt_states, env_state, key, eps):
        key, rkey = rnd.split(key.to(venv.device)).unbind(-2)
        env_state, traj = rollout(nets, env_state, rkey, eps)
        opt_states, metrics = learn(nets, target_nets, opt_states, traj, key)
        return nets, opt_states, env_state, metrics

    train_step.rollout = rollout
    train_step.learn = learn
    train_step.device = venv.device
    return train_step


def make_dqn_train_step_remat(venv: VecGridWorld, tx, gamma: float = 0.99,
                              rollout_len: int = 16, use_double: bool = True,
                              sample_steps: int = 2):
    """Fused DQN with observation rematerialization (train.py:325-490): the
    rollout stores the compact ``OBS_FIELDS`` snapshot of each step instead
    of its rendered windows, and the learner re-renders observations for
    ``sample_steps`` uniformly sampled steps, training on every agent of
    those steps.  Each sampled step's grid pass is rendered once and shared
    by both groups' losses.  The sampled steps are picked on the device
    (``index_select`` on the stacked snapshots, no host read).

    Same contract as :func:`make_dqn_train_step`, ``train_step.rollout`` and
    ``train_step.learn`` included."""
    spec = venv.spec
    if spec.turn_mode or spec.food_mode:
        raise ValueError("the remat trainer needs the NORTH-only observation "
                         "and static grids (no turn mode, no food)")
    G, B = spec.n_groups, venv.n_local
    caps = [g.cap for g in spec.groups]
    offs = [g.offset for g in spec.groups]
    grids_fn = venv._grids

    def at(t, idx):
        """``t[idx]`` for a 1-element index tensor on the device."""
        return t.index_select(0, idx)[0]

    def rebuild_state(template, traj, idx):
        """The state before rollout step ``idx`` (grid fields from the
        template: the observation renders from positions)."""
        return template.replace(**{f: at(traj["snap"][f], idx)
                                   for f in OBS_FIELDS})

    def step_loss(net, tnet, g, traj, s_t, s_t1, grids_t, grids_t1, idx):
        """(TD loss sum, mask sum) over every agent of group ``g`` at the
        sampled step ``idx`` (train.py:367-415)."""
        n_act = spec.groups[g].type.n_action
        sl = slice(offs[g], offs[g] + caps[g])
        with torch.no_grad():
            view, feat = venv.observe(s_t, g, grids_t)
            nview, nfeat = venv.observe(s_t1, g, grids_t1)
        q = net(*_rows(view, feat)).reshape(B, caps[g], n_act)
        act = at(traj["actions"], idx)[:, sl]
        q_t = q.gather(-1, act.long()[..., None])[..., 0]
        next_v = _next_value(net, tnet, *_rows(nview, nfeat),
                             use_double).reshape(B, caps[g])
        terminal = ~at(traj["alive"], idx)[:, sl] | at(traj["done"], idx)[
            :, None]
        return _td_loss(q_t, next_v, at(traj["rewards"], idx)[:, sl],
                        terminal, at(traj["alive_in"], idx)[:, sl], gamma)

    @deterministic_convolutions()
    def rollout(nets, env_state, key, eps):
        template = env_state  # grids and walls for the rebuilt states
        def act(state, akey):
            return _egreedy_actions(venv, nets, state, akey, eps)
        env_state, traj = _rollout(venv, act, env_state, key, rollout_len,
                                   store_obs=False)
        # snap[f][t] is the state before step t; t = rollout_len the state
        # after the rollout
        for f in OBS_FIELDS:
            traj["snap"][f] = torch.cat(
                [traj["snap"][f], getattr(env_state, f)[None]])
        traj["template"] = template
        return env_state, traj

    @deterministic_convolutions()
    def learn(nets, target_nets, opt_states, traj, key):
        ts = rnd.randint(key, (sample_steps,), 0, rollout_len).long()
        samples = []
        with torch.no_grad():
            for i in range(sample_steps):
                idx = ts[i:i + 1]
                s_t = rebuild_state(traj["template"], traj, idx)
                s_t1 = rebuild_state(traj["template"], traj, idx + 1)
                samples.append((s_t, s_t1, grids_fn(s_t), grids_fn(s_t1),
                                idx))
        opt_states = list(opt_states)
        losses = []
        for g in range(G):
            total = denom = 0.0
            for sample in samples:
                lt, lm = step_loss(nets[g], target_nets[g], g, traj, *sample)
                total = total + lt
                denom = denom + lm
            loss = total / sum_dp(denom, venv.mesh).clamp_min(1.0)
            opt_states[g] = _apply(nets[g], tx, opt_states[g], loss,
                                  venv.mesh)
            losses.append(sum_dp(loss.detach(), venv.mesh))
        metrics = dict(loss=torch.stack(losses), mean_reward=torch.stack(
            [_global_mean(venv, traj["rewards"][:, :, offs[g]:offs[g] + caps[g]])
             for g in range(G)]))
        return tuple(opt_states), metrics

    def train_step(nets, target_nets, opt_states, env_state, key, eps):
        key, rkey, skey = rnd.split(key.to(venv.device), 3).unbind(-2)
        env_state, traj = rollout(nets, env_state, rkey, eps)
        opt_states, metrics = learn(nets, target_nets, opt_states, traj, skey)
        return nets, opt_states, env_state, metrics

    train_step.rollout = rollout
    train_step.learn = learn
    train_step.device = venv.device
    return train_step


def make_a2c_train_step(venv: VecGridWorld, tx, gamma: float = 0.99,
                        rollout_len: int = 16, value_coef: float = 0.1,
                        ent_coef: float = 0.08):
    """Build ``train_step(nets, opt_states, env_state, key) -> (nets,
    opt_states, env_state, metrics)``: fused advantage actor-critic
    (train.py:493-655) with one :class:`~magent_tpu_torch.builtin.
    torch_model.A2CNet` per group.

    One call samples ``rollout_len`` steps from the current policies
    (group g draws ``categorical(fold_in(akey, g), log(policy))``, CommNet
    pooling over the start-of-step live agents, ``alive_in``), then takes
    one gradient step per group on n-step returns cut at ``~alive | done``
    and bootstrapped from the value of the post-rollout state times its
    live mask: policy gradient + ``value_coef`` x value MSE + ``ent_coef``
    x negative entropy, each over ``max(sum(alive_in), 1)``.  The
    bootstrap renders one more observation.  ``metrics``: ``loss``,
    ``mean_value`` and ``mean_reward``, ``[G]`` f32 on the device.
    ``train_step.rollout`` and ``train_step.learn`` are its two halves."""
    spec = venv.spec
    G, B, A = spec.n_groups, venv.n_local, spec.n_agents_cap
    group_slice = _group_slicer(spec)
    mesh = venv.mesh

    @deterministic_convolutions()
    def rollout(nets, env_state, key):
        def act(state, akey):
            live = (state.active & ~state.dead).float()
            actions = torch.zeros((B, A), dtype=torch.int32,
                                  device=venv.device)
            all_obs = venv.observe_all(state)
            for g in range(G):
                policy, _ = nets[g](*all_obs[g], group_slice(live, g))
                logits = policy.log()
                # the Gumbel noise at the global batch, this rank's rows
                noise = venv.local_rows(rnd.gumbel(
                    rnd.fold_in(akey, g),
                    (venv.n_envs,) + tuple(logits.shape[1:])))
                group_slice(actions, g)[:] = (noise + logits).argmax(-1).to(
                    torch.int32)
            return actions, [o[0] for o in all_obs], [o[1] for o in all_obs]

        return _rollout(venv, act, env_state, key, rollout_len,
                        store_obs=True)

    def group_loss(net, g, traj, boot_v):
        """(loss, mean value) over the rollout window (train.py:582-606)."""
        rew = group_slice(traj["rewards"], g)
        terminal = ~group_slice(traj["alive"], g) | traj["done"][:, :, None]
        R, rets = boot_v, []
        for t in reversed(range(rew.shape[0])):
            R = rew[t] + gamma * torch.where(terminal[t], 0.0, R)
            rets.append(R)
        rets = torch.stack(rets[::-1])
        # the start-of-step mask the sampling pass pooled over
        mask = group_slice(traj["alive_in"], g).float()
        policy, value = net(traj["views"][g], traj["feats"][g], mask)
        logp = (policy + 1e-6).log()
        act = group_slice(traj["actions"], g).long()
        lp_a = logp.gather(-1, act[..., None])[..., 0]
        adv = (rets - value).detach()
        msum = sum_dp(mask.sum(), mesh).clamp_min(1.0)
        pg = -(adv * lp_a * mask).sum() / msum
        vf = value_coef * ((rets - value).square() * mask).sum() / msum
        neg_ent = ent_coef * ((policy * logp).sum(-1) * mask).sum() / msum
        return pg + vf + neg_ent, (value * mask).sum() / msum

    @deterministic_convolutions()
    def learn(nets, opt_states, env_state, traj):
        """The gradient steps, from the post-rollout ``env_state``."""
        opt_states = list(opt_states)
        with torch.no_grad():
            final_obs = venv.observe_all(env_state)
            live = (env_state.active & ~env_state.dead).float()
        losses, values = [], []
        for g in range(G):
            m_fin = group_slice(live, g)
            with torch.no_grad():  # dead agents bootstrap 0
                boot_v = nets[g](*final_obs[g], m_fin)[1] * m_fin
            loss, mean_v = group_loss(nets[g], g, traj, boot_v)
            opt_states[g] = _apply(nets[g], tx, opt_states[g], loss, mesh)
            losses.append(sum_dp(loss.detach(), mesh))
            values.append(sum_dp(mean_v.detach(), mesh))
        metrics = dict(loss=torch.stack(losses), mean_value=torch.stack(values),
                       mean_reward=torch.stack(
                           [_global_mean(venv, group_slice(traj["rewards"], g))
                            for g in range(G)]))
        return tuple(opt_states), metrics

    def train_step(nets, opt_states, env_state, key):
        key, rkey = rnd.split(key.to(venv.device)).unbind(-2)
        env_state, traj = rollout(nets, env_state, rkey)
        opt_states, metrics = learn(nets, opt_states, env_state, traj)
        return nets, opt_states, env_state, metrics

    train_step.rollout = rollout
    train_step.learn = learn
    train_step.device = venv.device
    return train_step


def make_drqn_train_step(venv: VecGridWorld, tx, gamma: float = 0.99,
                         rollout_len: int = 8, use_double: bool = True,
                         unroll_remat="all", share_acting: bool = True):
    """Build ``train_step(nets, target_nets, opt_states, env_state,
    hiddens, key, eps) -> (nets, opt_states, env_state, hiddens,
    metrics)``: fused recurrent-Q training (train.py:658-904) with one
    :class:`~magent_tpu_torch.builtin.torch_model.DRQNNet` per group.

    The GRU state is carried per agent slot across calls (``hiddens``,
    one ``[B, cap, H]`` f32 tensor per group, :func:`init_drqn_hiddens`),
    zeroed after a death or an episode's end; each call acts e-greedily
    for ``rollout_len`` steps and takes one double-DQN (or max) TD step
    per group over the window, back-propagated through time from the
    window's initial state.  ``share_acting`` (JAX's default): the acting
    rollout runs under autograd, each per-step apply checkpointed, and its
    Q values are the online unroll; only the target nets re-unroll the
    stored window (:func:`split_unroll`).  ``share_acting=False``: the
    rollout runs under ``torch.no_grad`` and both nets re-unroll.
    ``unroll_remat`` is :func:`split_unroll`'s ``remat`` for those
    unrolls.  The returned hiddens are detached.  ``metrics``: ``loss``
    and ``mean_reward``, ``[G]`` f32 on the device.  ``train_step.rollout``
    and ``train_step.learn`` are its two halves."""
    spec = venv.spec
    G, B, A = spec.n_groups, venv.n_local, spec.n_agents_cap
    caps = [g.cap for g in spec.groups]
    group_slice = _group_slicer(spec)
    mesh = venv.mesh

    def net_step(net, h, view, feat):
        """One GRU step over ``[B, cap, ...]``."""
        h2, q = net(h.reshape(-1, net.state_size), *_rows(view, feat))
        return h2.reshape(h.shape), q.reshape(h.shape[:2] + (-1,))

    @deterministic_convolutions()
    def rollout(nets, env_state, hiddens, key, eps):
        """-> (env_state, hiddens, traj); with ``share_acting`` the Q values
        ``traj["qs"]`` and the hiddens carry the graph back to the
        parameters (and the window's initial state)."""
        steps, hs = [], list(hiddens)
        for _ in range(rollout_len):
            key, akey = rnd.split(key).unbind(-2)
            state = env_state
            with torch.no_grad():
                all_obs = venv.observe_all(state)
            actions = torch.zeros((B, A), dtype=torch.int32,
                                  device=venv.device)
            new_h, qs = [], []
            for g in range(G):
                if share_acting:
                    h2, q = checkpoint(net_step, nets[g], hs[g], *all_obs[g],
                                       use_reentrant=False)
                else:
                    with torch.no_grad():
                        h2, q = net_step(nets[g], hs[g], *all_obs[g])
                group_slice(actions, g)[:] = _egreedy(
                    q.detach(), rnd.fold_in(akey, g), eps, venv)
                new_h.append(h2)
                qs.append(q)
            with torch.no_grad():
                env_state, rewards, alive, done = venv.transition(state,
                                                                  actions)
            for g in range(G):
                keep = group_slice(alive, g) & ~done[:, None]
                hs[g] = torch.where(keep[..., None], new_h[g], 0.0)
            steps.append(dict(
                views=[o[0] for o in all_obs], feats=[o[1] for o in all_obs],
                qs=qs, actions=actions, rewards=rewards, alive=alive,
                alive_in=state.active & ~state.dead, done=done))
        return env_state, tuple(hs), _stack_steps(steps, G)

    def unroll_q(g, net, h0, traj):
        """Q ``[T, B, cap, n_act]`` of ``net`` over the stored window,
        resetting at the rollout's boundaries."""
        views, feats = traj["views"][g], traj["feats"][g]
        T = views.shape[0]
        keep = (group_slice(traj["alive"], g)
                & ~traj["done"][:, :, None]).reshape(T, -1, 1)
        q = split_unroll(net, views.reshape((T, -1) + tuple(views.shape[3:])),
                         feats.reshape(T, -1, feats.shape[-1]),
                         h0.reshape(-1, net.state_size), keep=keep,
                         remat=unroll_remat)
        return q.reshape(T, B, caps[g], -1)

    def td_loss(g, qs, tqs, traj):
        """Masked TD error over the window (train.py:812-834)."""
        act = group_slice(traj["actions"], g)
        q_t = qs[:-1].gather(-1, act[:-1].long()[..., None])[..., 0]
        if use_double:
            sel = qs[1:].detach().argmax(-1, keepdim=True)
            next_v = tqs[1:].gather(-1, sel)[..., 0]
        else:
            next_v = tqs[1:].max(-1).values
        terminal = (~group_slice(traj["alive"], g)[:-1]
                    | traj["done"][:-1][:, :, None])
        total, denom = _td_loss(q_t, next_v,
                                group_slice(traj["rewards"], g)[:-1],
                                terminal,
                                group_slice(traj["alive_in"], g)[:-1], gamma)
        return total / sum_dp(denom, mesh).clamp_min(1.0)

    @deterministic_convolutions()
    def learn(nets, target_nets, opt_states, h0, traj):
        """The gradient steps on the window that started from ``h0``.  The
        groups' losses are separable (they meet only in the env, which
        carries no gradient), so each group steps on its own backward."""
        opt_states = list(opt_states)
        losses = []
        for g in range(G):
            with torch.no_grad():
                tqs = unroll_q(g, target_nets[g], h0[g], traj)
            qs = (traj["qs"][g] if share_acting
                  else unroll_q(g, nets[g], h0[g], traj))
            loss = td_loss(g, qs, tqs, traj)
            opt_states[g] = _apply(nets[g], tx, opt_states[g], loss, mesh)
            losses.append(sum_dp(loss.detach(), mesh))
        metrics = dict(loss=torch.stack(losses), mean_reward=torch.stack(
            [_global_mean(venv, group_slice(traj["rewards"], g))
             for g in range(G)]))
        return tuple(opt_states), metrics

    def train_step(nets, target_nets, opt_states, env_state, hiddens, key,
                   eps):
        key, rkey = rnd.split(key.to(venv.device)).unbind(-2)
        h0 = hiddens
        env_state, hiddens, traj = rollout(nets, env_state, hiddens, rkey,
                                           eps)
        opt_states, metrics = learn(nets, target_nets, opt_states, h0, traj)
        # the kept chain was the BPTT path inside the step: cut it here
        return (nets, opt_states, env_state,
                tuple(h.detach() for h in hiddens), metrics)

    train_step.rollout = rollout
    train_step.learn = learn
    train_step.device = venv.device
    return train_step


def init_drqn_hiddens(venv: VecGridWorld, nets):
    """Zero per-agent GRU states, one ``[B, cap, H]`` f32 tensor per group
    on the env's device, for ``venv``'s env rows (train.py:907-914)."""
    spec = venv.spec
    return tuple(torch.zeros((venv.n_local, spec.groups[g].cap,
                              nets[g].state_size), device=venv.device)
                 for g in range(spec.n_groups))


def make_a2c_train_loop(venv: VecGridWorld, tx, steps_per_call: int,
                        **kwargs):
    """``steps_per_call`` steps of :func:`make_a2c_train_step` per call
    (train.py:917-934): ``loop(nets, opt_states, env_state, key) -> (nets,
    opt_states, env_state, metrics)``, metrics ``[steps_per_call, G]``."""
    train_step = make_a2c_train_step(venv, tx, **kwargs)

    def loop(nets, opt_states, env_state, key):
        key = key.to(venv.device)
        metrics = []
        for _ in range(steps_per_call):
            key, skey = rnd.split(key).unbind(-2)
            nets, opt_states, env_state, m = train_step(
                nets, opt_states, env_state, skey)
            metrics.append(m)
        return nets, opt_states, env_state, _stack(metrics)

    loop.train_step = train_step
    return loop


def make_drqn_train_loop(venv: VecGridWorld, tx, steps_per_call: int,
                         target_update: int, **kwargs):
    """``steps_per_call`` steps of :func:`make_drqn_train_step` per call
    with the target refresh (train.py:937-965): ``loop(nets, target_nets,
    opt_states, env_state, hiddens, key, eps, step0) -> (nets,
    target_nets, opt_states, env_state, hiddens, metrics)``, with
    :func:`make_dqn_train_loop`'s refresh rule."""
    train_step = make_drqn_train_step(venv, tx, **kwargs)
    return _scan_q_loop(train_step, steps_per_call, target_update,
                        n_carry=2)


def make_dqn_train_loop(venv: VecGridWorld, tx, steps_per_call: int,
                        target_update: int, **kwargs):
    """``steps_per_call`` train steps of :func:`make_dqn_train_step` per
    call, with the target refresh (train.py:968-990).  Returns
    ``loop(nets, target_nets, opt_states, env_state, key, eps, step0) ->
    (nets, target_nets, opt_states, env_state, metrics)``: metrics stacked
    over the call's steps (``[steps_per_call, G]`` on the device), and
    ``step0`` (an int) the global step count, which sets the refresh's
    phase: the target nets take the online weights after step ``t`` where
    ``(step0 + t + 1) % target_update == 0``."""
    train_step = make_dqn_train_step(venv, tx, **kwargs)
    return _scan_q_loop(train_step, steps_per_call, target_update)


def make_dqn_remat_train_loop(venv: VecGridWorld, tx, steps_per_call: int,
                              target_update: int, **kwargs):
    """The loop of :func:`make_dqn_train_step_remat`, the README's headline
    trainer (train.py:993-1005), with :func:`make_dqn_train_loop`'s
    contract."""
    train_step = make_dqn_train_step_remat(venv, tx, **kwargs)
    return _scan_q_loop(train_step, steps_per_call, target_update)


def _scan_q_loop(train_step, steps_per_call: int, target_update: int,
                 n_carry: int = 1):
    """train.py:1008-1029 as a Python loop.  The train step's env carry is
    ``n_carry`` values: the env state, and for DRQN also the hiddens."""

    def loop(nets, target_nets, opt_states, *args):
        carry, (key, eps, step0) = args[:n_carry], args[n_carry:]
        key = key.to(train_step.device)
        metrics = []
        for t in range(steps_per_call):
            key, skey = rnd.split(key).unbind(-2)
            nets, opt_states, *carry, m = train_step(
                nets, target_nets, opt_states, *carry, skey, eps)
            if (int(step0) + t + 1) % target_update == 0:
                with torch.no_grad():  # None: a scripted group's net
                    for tnet, net in zip(target_nets, nets):
                        if tnet is not None:
                            tnet.load_state_dict(net.state_dict())
            metrics.append(m)
        return (nets, target_nets, opt_states, *carry, _stack(metrics))

    loop.train_step = train_step
    return loop


def _stack(metrics):
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
