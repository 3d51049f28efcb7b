"""The port's fused A2C trainer (and its CommNet) against the JAX package's
on the CPU, f32, at ``tests/test_torch_port_train.py``'s size (battle map
20, caps [6, 6], B=4, rollout 3), each group's net initialized by flax
(``PRNGKey(g)``) and carried across with ``params_from_flax``; the
optimizer is ``clip_by_global_norm(5)`` then ``adam(1e-4)`` in both.  Each
JAX program is compiled once per module.

Tolerances, and why:
- ``uniform`` with ``minval``/``maxval``: bit for bit (XLA's fused
  multiply-add, replayed in float64);
- ``gumbel``: the bits are JAX's, the two ``log``s PyTorch's, within
  ``GUMBEL_ATOL`` (measured 4.77e-7); ``categorical`` and the trainer's
  actions: equal wherever JAX's top two ``logits + gumbel`` scores lie
  more than ``MARGIN`` apart, and every draw compared is asserted to clear
  it, so equality is never luck (softmax and ``log`` differ by an ulp
  between XLA and PyTorch);
- ``A2CNet`` in f32: rtol 1e-5, atol 1e-6; its bf16 trunk: ``BF16_ATOL``,
  the rule of ``tests/test_torch_port_train.py`` (flax rounds a layer's
  output before its bias add, PyTorch after it);
- the train step: the end state and every trajectory field exact; losses
  and ``mean_value`` rtol 1e-5; Adam moments and parameters by
  ``_torch_train_checks.assert_adam_steps_close``'s rule."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from magent_tpu.builtin.jax_model.a2c import A2CNet as JNet
from magent_tpu.parallel import train as jtrain

from magent_tpu_torch import random as trandom
from magent_tpu_torch.builtin.torch_model import (A2CNet, params_from_flax,
                                                  params_to_flax)
from magent_tpu_torch.parallel import (ClipAdam, make_a2c_train_loop,
                                       make_a2c_train_step)

from _torch_port_cases import (Pair, arrays_of, assert_states_equal,  # noqa: F401
                               jax_state, key_pair, one_torch_thread,
                               port_state)
from _torch_train_checks import assert_optax_steps_close, flatten_tree

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAP, CAPS, B, T = 20, [6, 6], 4, 3
LR, MAX_NORM = 1e-4, 5.0
MOMENT_RTOL = 1e-5
PARAM_ATOL = 0.2 * LR
BF16_ATOL = 0.05
GUMBEL_ATOL = 1e-6
MARGIN = 1e-5
TINY = float(np.finfo(np.float32).tiny)


def _jtx():
    return optax.chain(optax.clip_by_global_norm(MAX_NORM), optax.adam(LR))


@pytest.fixture(scope="module")
def world():
    """The paired envs, flax's initial parameters of both groups and the
    optimizer, per ``use_comm``."""
    pair = Pair("battle", MAP, CAPS, B)
    spec = pair.spec
    out = dict(pair=pair, tx=_jtx())
    for comm in (False, True):
        jnets = [JNet(spec.groups[g].type.n_action, use_comm=comm)
                 for g in range(2)]
        jparams = tuple(jnets[g].init(
            jax.random.PRNGKey(g),
            jnp.zeros((1,) + tuple(spec.view_space(g))),
            jnp.zeros((1, spec.feature_size(g))))["params"] for g in range(2))
        out[comm] = dict(jnets=jnets, jparams=jparams,
                         jopts=tuple(out["tx"].init(p) for p in jparams))
    return out


def port_nets(world, comm, dtype=torch.float32):
    spec = world["pair"].spec
    nets = []
    for g, jp in enumerate(world[comm]["jparams"]):
        net = A2CNet(spec.view_space(g), spec.feature_size(g),
                     spec.groups[g].type.n_action, use_comm=comm, dtype=dtype)
        net.load_state_dict(params_from_flax(flatten_tree(jp)))
        nets.append(net)
    return tuple(nets)


def start_state(world, seed=0):
    jkey, _ = key_pair(seed)
    arrays = arrays_of(world["pair"].reset(jkey))
    return jax_state(arrays), port_state(arrays)


# ---------------------------------------------------------------- sampler
@pytest.mark.parametrize("lo,hi", [(-3.5, 2.25), (TINY, 1.0), (0.1, 0.7),
                                   (5.0, 5.0001), (-1e-3, 1e6)])
def test_uniform_range_matches_jax(lo, hi):
    """``uniform(key, shape, minval, maxval)`` bit for bit, one key and a
    batch of keys."""
    for seed in (0, 7):
        jkey, tkey = key_pair(seed)
        want = np.asarray(jax.random.uniform(jkey, (4099,), minval=lo,
                                             maxval=hi))
        got = trandom.uniform(tkey, (4099,), lo, hi).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert got.min() >= np.float32(lo)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (5, 7), minval=lo, maxval=hi))(keys))
    got = trandom.uniform(trandom.split(trandom.PRNGKey(3), 3), (5, 7), lo, hi)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _margins(scores):
    """Top score minus the second, per draw."""
    top2 = np.sort(scores, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_gumbel_and_categorical_match_jax(seed):
    """``gumbel`` within GUMBEL_ATOL of JAX's (the uniform bits under it
    exact); ``categorical`` on a policy's log equal to JAX's draw wherever
    JAX's top two scores clear MARGIN, and the cleared draws are nearly
    all of them."""
    jkey, tkey = key_pair(seed)
    want = np.asarray(jax.random.gumbel(jkey, (50000,)))
    got = trandom.gumbel(tkey, (50000,)).numpy()
    np.testing.assert_allclose(got, want, atol=GUMBEL_ATOL, rtol=0)
    assert (got != want).any()  # not bit-equal: the logs differ

    logits = jax.nn.log_softmax(3.0 * jax.random.normal(
        jax.random.fold_in(jkey, 9), (B, 97, 21)))
    logp = jnp.log(jnp.clip(jax.nn.softmax(logits), 1e-10, 1 - 1e-10))
    want_a = np.asarray(jax.random.categorical(jkey, logp, axis=-1))
    scores = np.asarray(jax.random.gumbel(jkey, logp.shape) + logp)
    np.testing.assert_array_equal(scores.argmax(-1), want_a)
    got_a = trandom.categorical(tkey, torch.tensor(np.asarray(logp)))
    assert got_a.dtype == torch.int32 and got_a.shape == (B, 97)
    clear = _margins(scores) > MARGIN
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got_a.numpy()[clear], want_a[clear])


# ------------------------------------------------------------------ the net
def _masks():
    """Per env: nobody live, one live agent, some, all."""
    m = np.zeros((4, CAPS[0]), np.float32)
    m[1, 3] = 1
    m[2, [0, 2, 5]] = 1
    m[3] = 1
    return m


def _obs(world, steps=2):
    """Battle views and features of group 0 over a few random steps:
    [steps, B, cap, ...]."""
    pair = world["pair"]
    js, _ = start_state(world, 2)
    key = jax.random.PRNGKey(3)
    vs, fs = [], []
    for _ in range(steps):
        v, f = pair.observe_all(js)[0]
        vs.append(np.asarray(v))
        fs.append(np.asarray(f))
        key, akey = jax.random.split(key)
        js = pair.transition(js, pair.random_actions(akey))[0]
    return np.stack(vs), np.stack(fs)


@pytest.mark.parametrize("comm", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_a2c_net_matches_flax(world, comm, dtype):
    """Policy and value of both nets on real views, per env a mask with 0,
    1, 3 and 6 live agents (CommNet's message: 0 below two), the JAX
    trainer's vmap over envs and steps against the port's one batched
    call; ``params_to_flax`` gives flax's parameters back."""
    v, f = _obs(world)
    m = np.broadcast_to(_masks(), v.shape[:3]).copy()
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jnet = JNet(21, use_comm=comm, dtype=jdt)
    jp = world[comm]["jparams"][0]
    pol, val = jax.vmap(jax.vmap(lambda a, b, c: jnet.apply(
        {"params": jp}, a, b, c)))(v, f, m)
    net = port_nets(world, comm, tdt)[0]
    with torch.no_grad():
        tpol, tval = net(*(torch.from_numpy(a) for a in (v, f, m)))
    assert tpol.dtype == tval.dtype == torch.float32
    assert tpol.shape == (2, B, CAPS[0], 21) and tval.shape == (2, B, CAPS[0])
    if dtype == "f32":
        np.testing.assert_allclose(tpol.numpy(), np.asarray(pol), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tval.numpy(), np.asarray(val), rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(tpol.numpy(), np.asarray(pol), rtol=0,
                                   atol=BF16_ATOL)
        np.testing.assert_allclose(tval.numpy(), np.asarray(val), rtol=0,
                                   atol=BF16_ATOL)
    flat = flatten_tree(jp)
    back = params_to_flax(net)
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    if comm:  # the message moved the pooled envs' values and not env 0's
        plain = JNet(21, dtype=jdt)
        pv = jax.vmap(jax.vmap(lambda a, b: plain.apply(
            {"params": {k: jp[k] for k in jp if k != "comm"}}, a, b)))(v, f)
        assert not np.allclose(np.asarray(pv[1]), np.asarray(val))


def test_fresh_net_follows_flax_initializers():
    """Zero biases; dense and CommNet kernels at lecun_normal's scale
    (std 1 / sqrt(fan_in), truncated at two of the normal's std); the same
    generator seed gives the same net."""
    def fresh(seed):
        return A2CNet((13, 13, 7), 34, 21, use_comm=True,
                      generator=torch.Generator().manual_seed(seed))
    net = fresh(4)
    for name, p in net.state_dict().items():
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        fan_in = p.shape[1] if name.endswith("weight") else p.shape[0]
        std = float(p.std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.15, (name, std)
        assert float(p.abs().max()) <= 2 / .87962566103423978 / fan_in ** 0.5
    again = fresh(4).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in net.state_dict().items())
    assert not torch.equal(fresh(5).dense_view.weight, net.dense_view.weight)


# ------------------------------------------------------------ the trainer
@pytest.fixture(scope="module")
def jax_steps(world):
    """JAX's train step per ``use_comm``, compiled once."""
    return {comm: jax.jit(jtrain.make_a2c_train_step(
        world["pair"].jv, world[comm]["jnets"], world["tx"], rollout_len=T))
        for comm in (False, True)}


def _jax_margins(world, comm, traj, rkey):
    """JAX's top-two score gaps of every draw of the port's rollout: flax's
    policy on the recorded views under the recorded mask and the Gumbel
    noise of ``fold_in(akey, g)``, the key walk of train.py:539-552."""
    jnets, jparams = world[comm]["jnets"], world[comm]["jparams"]
    out = []
    key = rkey
    for t in range(T):
        key, akey = jax.random.split(key)
        for g in range(2):
            sl = slice(g * CAPS[0], (g + 1) * CAPS[0])
            pol, _ = jax.vmap(lambda a, b, c: jnets[g].apply(
                {"params": jparams[g]}, a, b, c))(
                traj["views"][g][t].numpy(), traj["feats"][g][t].numpy(),
                traj["alive_in"][t][:, sl].numpy().astype(np.float32))
            logp = jnp.log(pol)
            scores = np.asarray(jax.random.gumbel(
                jax.random.fold_in(akey, g), logp.shape) + logp)
            np.testing.assert_array_equal(traj["actions"][t][:, sl].numpy(),
                                          scores.argmax(-1))
            out.append(_margins(scores))
    return np.stack(out)


@pytest.mark.parametrize("comm", [False, True])
def test_a2c_train_step_matches_jax(world, jax_steps, comm):
    """One step: every draw of the rollout is JAX's (all clear MARGIN), the
    env state after it exact, losses and ``mean_value`` within rtol 1e-5,
    the Adam moments and parameters within their tolerances."""
    js, ts = start_state(world)
    jkey, tkey = key_pair(21)
    w = world[comm]
    jp, jo, jstate, jm = jax_steps[comm](w["jparams"], w["jopts"], js, jkey)
    tx = ClipAdam(LR, MAX_NORM)
    step = make_a2c_train_step(world["pair"].tv, tx, rollout_len=T)
    nets = port_nets(world, comm)
    _, traj = step.rollout(nets, ts, trandom.split(tkey)[1])
    margins = _jax_margins(world, comm, traj, jax.random.split(jkey)[1])
    assert margins.min() > MARGIN, margins.min()
    nets, opts, tstate, tm = step(nets, tuple(tx.init(n) for n in nets), ts,
                                  tkey)
    assert_states_equal(tstate, jstate, "env state")
    for name in ("loss", "mean_value"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-5, atol=0, err_msg=name)
    np.testing.assert_allclose(tm["mean_reward"].numpy(),
                               np.asarray(jm["mean_reward"]), rtol=1e-6)
    assert (traj["actions"].numpy() > 0).any()
    assert traj["views"][0].shape == (T, B, CAPS[0], 13, 13, 7)
    assert_optax_steps_close(nets, opts, jp, jo, lr=LR,
                             moment_rtol=MOMENT_RTOL, param_atol=PARAM_ATOL,
                             tag="a2c comm=%s" % comm)


def test_a2c_train_loop_matches_jax(world):
    """Two steps in one call: the end state exact, metrics ``[2, G]``
    within rtol 1e-5 of JAX's loop, parameters after two steps."""
    w = world[True]
    jloop = jax.jit(jtrain.make_a2c_train_loop(
        world["pair"].jv, w["jnets"], world["tx"], steps_per_call=2,
        rollout_len=T))
    js, ts = start_state(world, 1)
    jkey, tkey = key_pair(22)
    jp, jo, jstate, jm = jloop(w["jparams"], w["jopts"], js, jkey)
    tx = ClipAdam(LR, MAX_NORM)
    loop = make_a2c_train_loop(world["pair"].tv, tx, steps_per_call=2,
                               rollout_len=T)
    nets = port_nets(world, True)
    nets, opts, tstate, tm = loop(nets, tuple(tx.init(n) for n in nets), ts,
                                  tkey)
    assert_states_equal(tstate, jstate, "env state")
    assert tm["loss"].shape == (2, 2)
    for name in ("loss", "mean_value", "mean_reward"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-5, err_msg=name)
    assert_optax_steps_close(nets, opts, jp, jo, lr=LR, steps=2,
                             moment_rtol=MOMENT_RTOL, param_atol=PARAM_ATOL,
                             tag="a2c loop")


# ----------------------- tests/test_train_fused.py's A2C cases, on the port
def _setup_a2c(use_comm=False):
    """tests/test_train_fused.py:78-97 on the port: fresh nets (seeded per
    group) and plain Adam (1e-3), as that file's optax.adam(1e-3)."""
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.parallel import VecGridWorld

    venv = VecGridWorld(battle.get_config(20), [6, 6], 4, device="cpu")
    spec = venv.spec
    nets = tuple(A2CNet(spec.view_space(g), spec.feature_size(g),
                        spec.groups[g].type.n_action, use_comm=use_comm,
                        generator=torch.Generator().manual_seed(g))
                 for g in range(2))
    tx = ClipAdam(1e-3, float("inf"))
    return venv, nets, tx, make_a2c_train_step(venv, tx, rollout_len=3)


def test_a2c_train_step_moves_params():
    """tests/test_train_fused.py:100: two chained steps, finite metrics,
    parameters moved."""
    venv, nets, tx, step = _setup_a2c()
    before = [params_to_flax(n) for n in nets]
    opts = tuple(tx.init(n) for n in nets)
    state = venv.reset(trandom.PRNGKey(0))
    key = trandom.PRNGKey(1)
    for k in range(2):
        nets, opts, state, metrics = step(nets, opts, state,
                                          trandom.fold_in(key, k))
    assert torch.isfinite(metrics["loss"]).all()
    assert torch.isfinite(metrics["mean_value"]).all()
    for net, b in zip(nets, before):
        now = params_to_flax(net)
        assert max(float(np.abs(now[k] - b[k]).max()) for k in b) > 0


def test_a2c_commnet_fused():
    """tests/test_train_fused.py:111: one CommNet step, finite loss."""
    venv, nets, tx, step = _setup_a2c(use_comm=True)
    state = venv.reset(trandom.PRNGKey(0))
    _, _, _, metrics = step(nets, tuple(tx.init(n) for n in nets), state,
                            trandom.PRNGKey(1))
    assert torch.isfinite(metrics["loss"]).all()
