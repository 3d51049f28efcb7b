"""The port's fused DQN trainers against the JAX package's on the CPU, f32,
at ``tests/test_train_fused.py``'s size (battle map 20, caps [6, 6], B=4,
rollout 3), both groups starting from the repo's trusty battle checkpoints
(``data/models/trusty-battle-game-{l,r}/tfdqn_0.npz``) carried across with
``params_from_flax``; the optimizer is ``clip_by_global_norm(5)`` then
``adam(1e-4)`` in both.  Each JAX program is compiled once per module.

Tolerances, and why:
- trajectories (actions, rewards, liveness, done, views, features), the
  ``randint`` draws and the sampled minibatch indices: exact (eps 1.0 makes
  the actions independent of the Q values, and the keys are bit-equal);
- Q of the trusty weights in f32: rtol 1e-5, atol 1e-5 (XLA's and
  PyTorch's convolutions sum in other orders);
- losses: rtol 1e-5; Adam moments ``MOMENT_RTOL`` of each tensor's
  largest magnitude (the gradients carry those summation-order
  differences; measured 1.6e-6) and parameters ``PARAM_ATOL`` per step
  where the gradient's sign is settled (measured 4.8e-6), by
  ``_torch_train_checks.assert_adam_steps_close``'s rule;
- the bf16 trunk against flax's bf16 trunk: ``BF16_ATOL`` on Q values of
  magnitude ~3 (bf16 keeps 8 bits of mantissa, and the two frameworks
  round at other places: flax rounds a layer's output before its bias add,
  PyTorch after it), argmax equal wherever the top two Q values of flax's
  trunk lie further apart than ``BF16_ATOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from magent_tpu.builtin.jax_model.base import _flatten_pytree, _unflatten_pytree
from magent_tpu.builtin.jax_model.dqn import DQNNet as JNet
from magent_tpu.parallel import train as jtrain

from magent_tpu_torch import random as trandom
from magent_tpu_torch.builtin.torch_model import (DQNNet, params_from_flax,
                                                  params_to_flax)
from magent_tpu_torch.parallel import (ClipAdam, make_dqn_train_loop,
                                       make_dqn_train_step,
                                       make_dqn_train_step_remat, make_eval_q,
                                       sample_eval_set)

from _torch_port_cases import (Pair, arrays_of, assert_states_equal,
                               jax_state, key_pair, port_state)
from _torch_train_checks import assert_adam_steps_close, step_flat

MAP, CAPS, B, T = 20, [6, 6], 4, 3
LR, MAX_NORM = 1e-4, 5.0
TRUSTY = ["data/models/trusty-battle-game-%s/tfdqn_0.npz" % s for s in "lr"]
MOMENT_RTOL = 1e-5
PARAM_ATOL = 0.2 * LR
BF16_ATOL = 0.05


def _jtx():
    return optax.chain(optax.clip_by_global_norm(MAX_NORM), optax.adam(LR))


@pytest.fixture(scope="module")
def world():
    """The paired envs, the trusty weights in both packages, and the
    optimizers."""
    pair = Pair("battle", MAP, CAPS, B)
    flats = [dict(np.load(path)) for path in TRUSTY]
    spec = pair.spec
    jnets = [JNet(num_actions=spec.groups[g].type.n_action) for g in range(2)]
    jparams = tuple(_unflatten_pytree(f) for f in flats)
    tx = _jtx()
    return dict(pair=pair, flats=flats, jnets=jnets, jparams=jparams, tx=tx,
                jopts=tuple(tx.init(p) for p in jparams))


def port_nets(world, dtype=torch.float32):
    spec = world["pair"].spec
    nets = []
    for g, flat in enumerate(world["flats"]):
        net = DQNNet(spec.view_space(g), spec.feature_size(g),
                     spec.groups[g].type.n_action, dtype=dtype)
        net.load_state_dict(params_from_flax(flat))
        nets.append(net)
    return tuple(nets)


def start_state(world, seed=0):
    jkey, tkey = key_pair(seed)
    arrays = arrays_of(world["pair"].reset(jkey))
    return jax_state(arrays), port_state(arrays)


def assert_step_close(nets, opt_states, jparams, jopts, tag, steps=1):
    """The port's parameters and Adam state against optax's
    (``chain(clip, adam)``: its state is ``(clip state, (adam state, lr
    state))``), by ``assert_adam_steps_close``'s rule."""
    for g, ((params, moments), jp, jst) in enumerate(zip(
            step_flat(nets, opt_states), jparams, jopts)):
        adam = jst[1][0]
        assert opt_states[g].count == int(adam.count)
        assert_adam_steps_close(
            params, _flatten_pytree(jp), moments,
            (_flatten_pytree(adam.mu), _flatten_pytree(adam.nu)), lr=LR,
            steps=steps, moment_rtol=MOMENT_RTOL, param_atol=PARAM_ATOL,
            tag="%s group %d" % (tag, g))


# ------------------------------------------------------------------ randint
@pytest.mark.parametrize("span", [1, 21, 2**20 + 3, (T - 1) * B * CAPS[0]])
@pytest.mark.parametrize("shape", [(B, CAPS[0]), (16384,)])
def test_randint_matches_jax(span, shape):
    for seed in (0, 5):
        jkey, tkey = key_pair(seed)
        want = np.asarray(jax.random.randint(jkey, shape, 0, span))
        got = trandom.randint(tkey, shape, 0, span)
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().min() >= 0 and got.numpy().max() < span


def test_randint_bounds_match_jax():
    """Offsets, an empty range (minval alone) and a batch of keys."""
    jkey, tkey = key_pair(9)
    for lo, hi in ((-7, 30), (5, 5), (9, 2)):
        want = np.asarray(jax.random.randint(jkey, (33,), lo, hi))
        np.testing.assert_array_equal(
            trandom.randint(tkey, (33,), lo, hi).numpy(), want)
    keys = jax.random.split(jkey, 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (5,), 0, 21))(keys))
    got = trandom.randint(trandom.split(tkey, 3), (5,), 0, 21)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ the net
def _real_obs(world, n_steps=3):
    """Battle observations of both groups over a few random steps."""
    pair = world["pair"]
    js, _ = start_state(world, 2)
    key = jax.random.PRNGKey(3)
    obs = [[], []]
    for _ in range(n_steps):
        for g, (v, f) in enumerate(pair.observe_all(js)):
            obs[g].append((np.asarray(v).reshape((-1,) + v.shape[2:]),
                           np.asarray(f).reshape(-1, f.shape[-1])))
        key, akey = jax.random.split(key)
        js = pair.transition(js, pair.random_actions(akey))[0]
    return [(np.concatenate([o[0] for o in ob]),
             np.concatenate([o[1] for o in ob])) for ob in obs]


@pytest.mark.parametrize("group", [0, 1])
def test_trusty_q_matches_flax(world, group):
    """The port's Q of each trusty checkpoint equals flax's on real battle
    observations (f32); ``params_to_flax`` gives the checkpoint back
    exactly; the bf16 trunk stays within BF16_ATOL of flax's bf16 trunk."""
    v, f = _real_obs(world)[group]
    flat = world["flats"][group]
    params = _unflatten_pytree(flat)
    want = np.asarray(JNet(21).apply({"params": params}, v, f))
    net = port_nets(world)[group]
    got = net(torch.from_numpy(v), torch.from_numpy(f)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = params_to_flax(net)
    assert set(back) == set(flat)
    for name in flat:
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], flat[name])

    want16 = np.asarray(JNet(21, dtype=jnp.bfloat16).apply(
        {"params": params}, v, f))
    net16 = port_nets(world, torch.bfloat16)[group]
    got16 = net16(torch.from_numpy(v), torch.from_numpy(f)).detach()
    assert got16.dtype == torch.float32  # the heads run in f32
    np.testing.assert_allclose(got16.numpy(), want16, rtol=0, atol=BF16_ATOL)
    top2 = np.sort(want16, 1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > BF16_ATOL
    assert clear.any()  # the argmax check is not empty
    np.testing.assert_array_equal(got16.numpy().argmax(1)[clear],
                                  want16.argmax(1)[clear])


@pytest.mark.parametrize("use_dueling,use_conv", [(False, True),
                                                  (True, False)])
def test_net_variants_match_flax(use_dueling, use_conv):
    """The non-dueling head and the conv-less trunk, from a flax init."""
    rng = np.random.RandomState(4)
    v = (rng.uniform(size=(6, 5, 5, 3)) < 0.3).astype(np.float32)
    f = rng.uniform(size=(6, 4)).astype(np.float32)
    jnet = JNet(7, use_dueling=use_dueling, use_conv=use_conv)
    params = jnet.init(jax.random.PRNGKey(0), v, f)["params"]
    net = DQNNet((5, 5, 3), 4, 7, use_dueling=use_dueling, use_conv=use_conv)
    net.load_state_dict(params_from_flax(_flatten_pytree(params)))
    got = net(torch.from_numpy(v), torch.from_numpy(f)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(
        {"params": params}, v, f)), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the trainers
def _jax_rollout(world):
    """The JAX trainer's rollout (train.py:155-192), rebuilt from its
    pieces so that its trajectory can be compared: compiled once."""
    pair, jnets = world["pair"], world["jnets"]

    def rollout(params, state, key, eps):
        steps = []
        for _ in range(T):
            key, akey = jax.random.split(key)
            alive_in = state.active & ~state.dead
            actions, views, feats = jtrain._egreedy_actions(
                pair.jv, jnets, params, state, akey, eps, return_obs=True)
            state, rewards, alive, done = pair.jv.transition(state, actions)
            steps.append(dict(views=views, feats=feats, actions=actions,
                              rewards=rewards, alive=alive,
                              alive_in=alive_in, done=done))
        return state, steps

    return jax.jit(rollout)


@pytest.fixture(scope="module")
def dqn_steps(world):
    """The JAX step (whole-rollout and minibatch losses), compiled once."""
    pair = world["pair"]
    return {(mb, double): jax.jit(jtrain.make_dqn_train_step(
        pair.jv, world["jnets"], world["tx"], rollout_len=T,
        train_minibatch=mb, use_double=double)) for mb, double in STEP_FORMS}


def _port_step(world, **kw):
    return make_dqn_train_step(world["pair"].tv, ClipAdam(LR, MAX_NORM),
                               rollout_len=T, **kw)


def test_rollout_matches_jax(world):
    """eps 1.0: the trajectory, every field of it, is exactly the JAX
    trainer's, and so is the env state it ends in."""
    js, ts = start_state(world)
    jkey, tkey = key_pair(11)
    jfinal, jsteps = _jax_rollout(world)(world["jparams"], js, jkey, 1.0)
    step = _port_step(world)
    tfinal, traj = step.rollout(port_nets(world), ts, tkey, 1.0)
    assert_states_equal(tfinal, jfinal, "after the rollout")
    for name in ("actions", "rewards", "alive", "alive_in", "done"):
        want = np.stack([np.asarray(s[name]) for s in jsteps])
        got = traj[name].numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("views", "feats"):
        for g in range(2):
            want = np.stack([np.asarray(s[name][g]) for s in jsteps])
            np.testing.assert_array_equal(traj[name][g].numpy(), want,
                                          err_msg="%s group %d" % (name, g))
    assert (traj["actions"].numpy() > 0).any()


# (train_minibatch, use_double): the whole-rollout loss and the sampled
# one, with the double-DQN target and with the plain max
STEP_FORMS = [(None, True), (32, True), (32, False)]


@pytest.mark.parametrize("minibatch,double", STEP_FORMS)
def test_dqn_train_step_matches_jax(world, dqn_steps, minibatch, double,
                                    monkeypatch):
    """One step, eps 1.0: the env state exact, the losses within rtol 1e-5,
    the Adam moments and the updated parameters within their tolerances;
    with ``train_minibatch`` the sampled indices equal the JAX draw."""
    draws = []
    real = trandom.randint

    def recording(key, shape, lo, hi):
        out = real(key, shape, lo, hi)
        if tuple(shape) == (minibatch,):
            draws.append((hi, out.clone()))
        return out

    monkeypatch.setattr(trandom, "randint", recording)
    js, ts = start_state(world)
    jkey, tkey = key_pair(12)
    jp, jo, jstate, jm = dqn_steps[minibatch, double](
        world["jparams"], world["jparams"], world["jopts"], js, jkey, 1.0)
    nets = port_nets(world)
    tx = ClipAdam(LR, MAX_NORM)
    nets, opts, tstate, tm = _port_step(world, train_minibatch=minibatch,
                                        use_double=double)(
        nets, port_nets(world), tuple(tx.init(n) for n in nets), ts, tkey,
        1.0)
    assert_states_equal(tstate, jstate, "env state")
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(tm["mean_reward"].numpy(),
                               np.asarray(jm["mean_reward"]), rtol=1e-6)
    assert (tm["loss"].numpy() > 0).all()
    assert_step_close(nets, opts, jp, jo, "step")
    moved = [np.abs(params_to_flax(n)["conv1/kernel"] - f["conv1/kernel"])
             .max() for n, f in zip(nets, world["flats"])]
    assert min(moved) > 0.5 * LR
    if minibatch is None:
        assert not draws
        return
    key = jax.random.split(jkey)[0]  # train_step: key, rkey = split(key)
    span = (T - 1) * B * CAPS[0]
    assert [hi for hi, _ in draws] == [span, span]
    for g, (_, got) in enumerate(draws):
        want = jax.random.randint(jax.random.fold_in(key, 1000 + g),
                                  (minibatch,), 0, span)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dqn_train_loop_refreshes_target_with_jax(world):
    """``steps_per_call=3``, ``target_update=2``, ``step0=0``: the target
    takes the online weights after the second step, as in the JAX loop,
    and not after the third; from ``step0=1`` it does after the third."""
    jloop = jax.jit(jtrain.make_dqn_train_loop(
        world["pair"].jv, world["jnets"], world["tx"], steps_per_call=3,
        target_update=2, rollout_len=T))
    js, ts = start_state(world)
    jkey, tkey = key_pair(13)
    jp, jt, jo, jstate, jm = jloop(world["jparams"], world["jparams"],
                                   world["jopts"], js, jkey, 1.0, 0)
    loop = make_dqn_train_loop(world["pair"].tv, ClipAdam(LR, MAX_NORM),
                               steps_per_call=3, target_update=2,
                               rollout_len=T)
    tx = ClipAdam(LR, MAX_NORM)
    nets = port_nets(world)
    opts = tuple(tx.init(n) for n in nets)
    nets, tnets, opts, tstate, tm = loop(nets, port_nets(world), opts, ts,
                                         tkey, 1.0, 0)
    assert_states_equal(tstate, jstate, "env state")
    assert tm["loss"].shape == (3, 2)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    assert_step_close(nets, opts, jp, jo, "loop", steps=3)
    # the target holds the weights after the second step: exactly those of
    # a two-step call, and JAX's target by the same rule
    loop2 = make_dqn_train_loop(world["pair"].tv, tx, steps_per_call=2,
                                target_update=2, rollout_len=T)
    nets2 = port_nets(world)
    nets2, _, opts2, _, _ = loop2(nets2, port_nets(world),
                                  tuple(tx.init(n) for n in nets2),
                                  start_state(world)[1], tkey, 1.0, 0)
    for g, ((params2, moments2), tnet, net) in enumerate(zip(
            step_flat(nets2, opts2), tnets, nets)):
        target, online = params_to_flax(tnet), params_to_flax(net)
        assert all(np.array_equal(target[k], params2[k]) for k in params2)
        assert any(not np.array_equal(target[k], online[k]) for k in online)
        assert_adam_steps_close(target, _flatten_pytree(jt[g]), moments2,
                                moments2, lr=LR, steps=2,
                                moment_rtol=MOMENT_RTOL,
                                param_atol=PARAM_ATOL, tag="target %d" % g)

    nets, tnets, _, _, _ = loop(port_nets(world), port_nets(world),
                                tuple(tx.init(n) for n in port_nets(world)),
                                ts, tkey, 1.0, 1)
    for net, tnet in zip(nets, tnets):
        t, o = params_to_flax(tnet), params_to_flax(net)
        assert all(np.array_equal(t[k], o[k]) for k in o)


def test_dqn_remat_step_matches_jax(world):
    """One remat step (two sampled steps re-rendered): env state exact,
    losses, moments and parameters as the plain step's."""
    jstep = jax.jit(jtrain.make_dqn_train_step_remat(
        world["pair"].jv, world["jnets"], world["tx"], rollout_len=T,
        sample_steps=2))
    js, ts = start_state(world)
    jkey, tkey = key_pair(14)
    jp, jo, jstate, jm = jstep(world["jparams"], world["jparams"],
                               world["jopts"], js, jkey, 1.0)
    tx = ClipAdam(LR, MAX_NORM)
    nets = port_nets(world)
    step = make_dqn_train_step_remat(world["pair"].tv, tx, rollout_len=T,
                                     sample_steps=2)
    nets, opts, tstate, tm = step(nets, port_nets(world),
                                  tuple(tx.init(n) for n in nets), ts, tkey,
                                  1.0)
    assert_states_equal(tstate, jstate, "env state")
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(tm["mean_reward"].numpy(),
                               np.asarray(jm["mean_reward"]), rtol=1e-6)
    assert_step_close(nets, opts, jp, jo, "remat")


def test_train_step_keeps_scripted_groups(world):
    """``train_groups=[0]``: group 1 acts at random with the JAX draws,
    keeps its net, and reports loss 0."""
    jstep = jax.jit(jtrain.make_dqn_train_step(
        world["pair"].jv, world["jnets"], world["tx"], rollout_len=T,
        train_groups=[0]))
    js, ts = start_state(world)
    jkey, tkey = key_pair(15)
    _, _, jstate, jm = jstep(world["jparams"], world["jparams"],
                             world["jopts"], js, jkey, 0.5)
    tx = ClipAdam(LR, MAX_NORM)
    nets = port_nets(world)
    nets, _, tstate, tm = _port_step(world, train_groups=[0])(
        nets, port_nets(world), tuple(tx.init(n) for n in nets), ts, tkey,
        0.5)
    assert_states_equal(tstate, jstate, "env state")
    assert float(tm["loss"][1]) == 0.0 == float(jm["loss"][1])
    np.testing.assert_allclose(float(tm["loss"][0]), float(jm["loss"][0]),
                               rtol=1e-5)
    kept = params_to_flax(nets[1])
    assert all(np.array_equal(kept[k], world["flats"][1][k]) for k in kept)


def test_eval_set_and_eval_q_match_jax(world):
    pair = world["pair"]
    jkey, tkey = key_pair(16)
    jv, jf = jtrain.sample_eval_set(pair.jv, 0, n_steps=3, key=jkey)
    tv, tf = sample_eval_set(pair.tv, 0, n_steps=3, key=tkey)
    assert tv.shape == (3 * B * CAPS[0], 13, 13, 7)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    want = jtrain.make_eval_q(pair.jv, world["jnets"], 0)(
        world["jparams"], jv, jf)
    got = make_eval_q(pair.tv, 0)(port_nets(world), tv, tf)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)

