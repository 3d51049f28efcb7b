"""Fused rollout + learner steps of the DQN family (port of the DQN half of
``magent_tpu/parallel/train.py``).

A train step rolls ``rollout_len`` lockstep env steps with e-greedy
policies (``torch.no_grad``), then takes one double-DQN gradient step per
group, with everything on the env's device.  Where the JAX package passes
flax modules (``nets``) and their parameter pytrees (``params``), the port
passes one :class:`~magent_tpu_torch.builtin.torch_model.DQNNet` per group,
module and parameters in one: a train step updates the online nets in place
and returns them, the loop refreshes the target nets in place
(``load_state_dict``) where the JAX loop selects new target params, and
``tx`` is a :class:`~magent_tpu_torch.parallel.optim.ClipAdam` whose
per-group states (``tx.init(net)``) play optax's.  Each group needs a
module of its own (and a separate target copy): the groups train
independently, as in the JAX package.

Keys are the port's int64 ``[2]`` threefry keys (:mod:`magent_tpu_torch.random`),
bit-equal to ``jax.random``'s, so a step from the same key draws the same
actions and minibatch as the JAX step.  Metrics stay on the device, stacked
per call; the only host reads inside a step are the env's auto-reset checks
(one per env step, ``VecGridWorld.transition``).  Python loops take the
place of ``lax.scan``.

Not ported yet (``ROADMAP.md``): the A2C and DRQN trainers and
``parallel/sharding.py``.
"""

from __future__ import annotations

import torch

from .. import random as rnd
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


def _egreedy_actions(venv: VecGridWorld, nets, state, key, eps,
                     return_obs=False, train_groups=None):
    """e-greedy actions ``[B, A]`` int32 for every group over the full slot
    axis (train.py:20-69); with ``return_obs`` also the rendered views and
    features per group.  Groups outside ``train_groups`` act uniformly at
    random and render nothing (scripted opponents)."""
    spec = venv.spec
    B, A = venv.n_envs, spec.n_agents_cap
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
        kg, kr = rnd.split(rnd.fold_in(key, g)).unbind(-2)
        sl = slice(gs.offset, gs.offset + gs.cap)
        if g not in tg:
            actions[:, sl] = rnd.randint(kg, (B, gs.cap), 0, n_act)
            views.append(None)
            feats.append(None)
            continue
        view, feat = all_obs[g]  # [B, cap, vh, vw, C], [B, cap, F]
        with torch.no_grad():
            q = nets[g](*_rows(view, feat)).reshape(B, gs.cap, n_act)
        greedy = q.argmax(-1).to(torch.int32)
        rand = rnd.randint(kg, greedy.shape, 0, n_act)
        actions[:, sl] = torch.where(rnd.uniform(kr, greedy.shape) < eps,
                                     rand, greedy)
        views.append(view)
        feats.append(feat)
    if return_obs:
        return actions, views, feats
    return actions


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
    del venv  # the JAX signature's; the nets carry what eval_q needs

    def eval_q(nets, views, feats):
        with torch.no_grad():
            return nets[group](views, feats).max(-1).values.mean()

    return eval_q


def _rollout(venv: VecGridWorld, nets, env_state, key, eps, rollout_len,
             train_groups, store_obs):
    """``rollout_len`` e-greedy steps under ``torch.no_grad`` -> (env_state,
    per-step records stacked on a leading T axis).  ``store_obs`` keeps
    each group's views and features (the plain trainer's trajectory); the
    remat trainer keeps the compact ``OBS_FIELDS`` snapshots instead."""
    steps = []
    with torch.no_grad():
        for _ in range(rollout_len):
            key, akey = rnd.split(key).unbind(-2)
            state = env_state
            # start-of-step liveness: right across auto-resets, where the
            # last step's end-of-step alive belongs to the old episode
            rec = dict(alive_in=state.active & ~state.dead)
            if store_obs:
                actions, views, feats = _egreedy_actions(
                    venv, nets, state, akey, eps, return_obs=True,
                    train_groups=train_groups)
                rec.update(views=views, feats=feats)
            else:
                actions = _egreedy_actions(venv, nets, state, akey, eps,
                                           train_groups=train_groups)
                rec["snap"] = {f: getattr(state, f) for f in OBS_FIELDS}
            env_state, rewards, alive, done = venv.transition(state, actions)
            rec.update(actions=actions, rewards=rewards, alive=alive,
                       done=done)
            steps.append(rec)

    def stack(get):
        return torch.stack([get(r) for r in steps])

    traj = {name: stack(lambda r, n=name: r[n])
            for name in ("alive_in", "actions", "rewards", "alive", "done")}
    if store_obs:
        for name in ("views", "feats"):
            traj[name] = [None if steps[0][name][g] is None else
                          stack(lambda r, n=name, g=g: r[n][g])
                          for g in range(venv.spec.n_groups)]
    else:
        traj["snap"] = {f: stack(lambda r, f=f: r["snap"][f])
                        for f in OBS_FIELDS}
    return env_state, traj


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


def _apply(net, tx, opt_state, loss):
    """Backward and one ``tx`` step on ``net`` in place -> new state."""
    net.zero_grad(set_to_none=True)
    loss.backward()
    return tx.update(net, opt_state)


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
    G, B = spec.n_groups, venv.n_envs
    caps = [g.cap for g in spec.groups]
    offs = [g.offset for g in spec.groups]
    tg = _groups(venv, train_groups)

    def group_slice(t, g):
        return t[..., offs[g]:offs[g] + caps[g]]

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
        cur = rnd.randint(skey, (K,), 0, (T - 1) * B * cap).long()
        nxt = cur + B * cap  # the same (env, agent) one step later

        def rows(ix):
            return flat_v.index_select(0, ix).reshape((K,) + vshape), \
                flat_f.index_select(0, ix)

        q_t = net(*rows(cur)).gather(1, act[cur].long()[:, None])[:, 0]
        next_v = _next_value(net, tnet, *rows(nxt), use_double)
        total, denom = _td_loss(q_t, next_v, rew[cur], term[cur], prev[cur],
                                gamma)
        return total / denom.clamp_min(1.0)

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
        return total / denom.clamp_min(1.0)

    def rollout(nets, env_state, key, eps):
        return _rollout(venv, nets, env_state, key, eps, rollout_len,
                        train_groups, store_obs=True)

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
            opt_states[g] = _apply(nets[g], tx, opt_states[g], loss)
            losses.append(loss.detach())
        metrics = dict(loss=torch.stack(losses), mean_reward=torch.stack(
            [group_slice(traj["rewards"], g).mean() for g in range(G)]))
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
    G, B = spec.n_groups, venv.n_envs
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

    def rollout(nets, env_state, key, eps):
        template = env_state  # grids and walls for the rebuilt states
        env_state, traj = _rollout(venv, nets, env_state, key, eps,
                                   rollout_len, None, store_obs=False)
        # snap[f][t] is the state before step t; t = rollout_len the state
        # after the rollout
        for f in OBS_FIELDS:
            traj["snap"][f] = torch.cat(
                [traj["snap"][f], getattr(env_state, f)[None]])
        traj["template"] = template
        return env_state, traj

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
            loss = total / denom.clamp_min(1.0)
            opt_states[g] = _apply(nets[g], tx, opt_states[g], loss)
            losses.append(loss.detach())
        metrics = dict(loss=torch.stack(losses), mean_reward=torch.stack(
            [traj["rewards"][:, :, offs[g]:offs[g] + caps[g]].mean()
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


def _scan_q_loop(train_step, steps_per_call: int, target_update: int):
    """train.py:1008-1029 as a Python loop."""

    def loop(nets, target_nets, opt_states, env_state, key, eps, step0):
        key = key.to(train_step.device)
        metrics = []
        for t in range(steps_per_call):
            key, skey = rnd.split(key).unbind(-2)
            nets, opt_states, env_state, m = train_step(
                nets, target_nets, opt_states, env_state, skey, eps)
            if (int(step0) + t + 1) % target_update == 0:
                with torch.no_grad():
                    for tnet, net in zip(target_nets, nets):
                        tnet.load_state_dict(net.state_dict())
            metrics.append(m)
        stacked = {k: torch.stack([m[k] for m in metrics])
                   for k in metrics[0]}
        return nets, target_nets, opt_states, env_state, stacked

    loop.train_step = train_step
    return loop
