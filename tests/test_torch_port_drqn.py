"""The port's fused DRQN trainer, its GRU net and ``split_unroll`` against
the JAX package's on the CPU, f32, at ``tests/test_torch_port_train.py``'s
size (battle map 20, caps [6, 6], B=4, rollout 3), each group's net (state
size 512) initialized by flax (``PRNGKey(g)``) and carried across with
``params_from_flax``; the optimizer is ``clip_by_global_norm(5)`` then
``adam(1e-4)`` in both.  Each JAX program is compiled once per module.

Tolerances, and why:
- the cell, ``DRQNNet`` and ``split_unroll`` in f32: rtol 1e-5, atol
  1e-6 (XLA and PyTorch sum the matmuls in other orders); in bf16:
  ``BF16_ATOL``, the rule of ``tests/test_torch_port_train.py`` (flax
  rounds a layer's output before its bias add, PyTorch after it);
- the train step and the loop, eps 1.0 (the actions do not read the Q
  values): the end state exact, losses and the returned hiddens rtol 1e-5
  (atol 1e-6 for hiddens near 0), Adam moments and parameters by
  ``_torch_train_checks.assert_adam_steps_close``'s rule."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from magent_tpu.builtin.jax_model import drqn as jdrqn
from magent_tpu.parallel import train as jtrain

from magent_tpu_torch import random as trandom
from magent_tpu_torch.builtin.torch_model import (DRQNNet, params_from_flax,
                                                  params_to_flax, split_unroll)
from magent_tpu_torch.builtin.torch_model.drqn import GRUCell
from magent_tpu_torch.parallel import (ClipAdam, init_drqn_hiddens,
                                       make_drqn_train_loop,
                                       make_drqn_train_step)

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
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (share_acting, unroll_remat): both loss forms, a stored and a
# recomputed unroll
STEP_FORMS = [(True, "all"), (True, False), (False, "all"), (False, False)]


def _jtx():
    return optax.chain(optax.clip_by_global_norm(MAX_NORM), optax.adam(LR))


@pytest.fixture(scope="module")
def world():
    """The paired envs, flax's initial parameters of both groups and the
    optimizer."""
    pair = Pair("battle", MAP, CAPS, B)
    spec = pair.spec
    jnets = [jdrqn.DRQNNet(spec.groups[g].type.n_action) for g in range(2)]
    jparams = tuple(jnets[g].init(
        jax.random.PRNGKey(g), jnp.zeros((1, 512)),
        jnp.zeros((1,) + tuple(spec.view_space(g))),
        jnp.zeros((1, spec.feature_size(g))))["params"] for g in range(2))
    tx = _jtx()
    return dict(pair=pair, jnets=jnets, jparams=jparams, tx=tx,
                jopts=tuple(tx.init(p) for p in jparams))


def port_nets(world, params=None):
    spec = world["pair"].spec
    nets = []
    for g, jp in enumerate(params or world["jparams"]):
        net = DRQNNet(spec.view_space(g), spec.feature_size(g),
                      spec.groups[g].type.n_action)
        net.load_state_dict(params_from_flax(flatten_tree(jp)))
        nets.append(net)
    return tuple(nets)


def start_state(world, seed=0):
    jkey, _ = key_pair(seed)
    arrays = arrays_of(world["pair"].reset(jkey))
    return jax_state(arrays), port_state(arrays)


def _window(seed, n_t=4, n=6, view=(5, 5, 4), n_feat=7, state=512):
    """Random frames ``[T, N, ...]``, features, a keep mask with resets and
    an initial state."""
    rng = np.random.RandomState(seed)
    v = rng.uniform(size=(n_t, n) + view).astype(np.float32)
    f = rng.uniform(size=(n_t, n, n_feat)).astype(np.float32)
    keep = rng.uniform(size=(n_t, n, 1)) < 0.7
    h0 = (0.3 * rng.normal(size=(n, state))).astype(np.float32)
    return v, f, keep, h0


def _flax_drqn(seed, dueling=True, dtype="f32", state=512):
    v, f, _, _ = _window(seed, state=state)
    jnet = jdrqn.DRQNNet(9, use_dueling=dueling, state_size=state,
                         dtype=DTYPES[dtype][0])
    p = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, state)), v[0, :1],
                  f[0, :1])["params"]
    net = DRQNNet((5, 5, 4), 7, 9, use_dueling=dueling, state_size=state,
                  dtype=DTYPES[dtype][1])
    net.load_state_dict(params_from_flax(flatten_tree(p)))
    return jnet, p, net


def _close(got, want, dtype, err_msg=""):
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL,
                                   err_msg=err_msg)


# ------------------------------------------------------------------ the net
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gru_cell_matches_flax(dtype):
    """flax ``GRUCell`` (``dtype`` compute, f32 parameters) step for step,
    from flax's initializers; the cell's parameter names are flax's."""
    import flax.linen as fnn

    rng = np.random.RandomState(1)
    x = rng.normal(size=(7, 512)).astype(np.float32)
    h = (0.5 * rng.normal(size=(7, 512))).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    cell = fnn.GRUCell(512, dtype=jdt, param_dtype=jnp.float32)
    p = cell.init(jax.random.PRNGKey(2), h, x)["params"]
    want = np.asarray(cell.apply({"params": p}, h.astype(jdt),
                                 x.astype(jdt))[0].astype(jnp.float32))
    tcell = GRUCell(512, 512, tdt)
    tcell.load_state_dict(params_from_flax(flatten_tree(p)))
    assert set(flatten_tree(p)) == set(params_to_flax(tcell))
    with torch.no_grad():
        got = tcell(torch.from_numpy(h), torch.from_numpy(x))
    # the state in the cell's dtype, widened to the carried state's f32
    assert got.dtype == torch.float32
    assert torch.equal(got, got.to(tdt).float())
    _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dueling", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_drqn_net_matches_flax(dueling, dtype):
    """One step of ``DRQNNet`` (new state, Q) on flax's parameters; the
    state and Q are f32 in both dtypes; ``params_to_flax`` gives the
    parameters back exactly."""
    v, f, _, h0 = _window(3)
    jnet, p, net = _flax_drqn(3, dueling, dtype)
    jh, jq = jnet.apply({"params": p}, h0, v[0], f[0])
    with torch.no_grad():
        th, tq = net(*(torch.from_numpy(a) for a in (h0, v[0], f[0])))
    assert th.dtype == tq.dtype == torch.float32
    _close(th.numpy(), np.asarray(jh), dtype, "state")
    _close(tq.numpy(), np.asarray(jq), dtype, "q")
    flat = flatten_tree(p)
    back = params_to_flax(net)
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


@pytest.mark.parametrize("remat", [False, "dots", "all"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_unroll_matches_jax(remat, dtype):
    """``split_unroll`` with resets against JAX's (the same ``remat``), and
    its gradient with respect to every parameter and to ``h0`` the same
    in every ``remat`` form (f32: each form stores or recomputes the same
    values)."""
    v, f, keep, h0 = _window(4)
    jnet, p, net = _flax_drqn(4, dtype=dtype)
    want = np.asarray(jdrqn.split_unroll(jnet, p, v, f, h0, keep=keep,
                                         remat=remat))
    args = [torch.from_numpy(a) for a in (v, f, h0, keep)]
    with torch.no_grad():
        got = split_unroll(net, *args[:3], keep=args[3], remat=remat)
    assert got.shape == (4, 6, 9)
    _close(got.numpy(), want, dtype)
    if dtype == "bf16":
        return
    grads = []
    for form in (False, remat):
        h = args[2].clone().requires_grad_(True)
        net.zero_grad()
        q = split_unroll(net, args[0], args[1], h, keep=args[3], remat=form)
        (q * torch.linspace(-1, 1, q.numel()).reshape(q.shape)).sum().backward()
        grads.append([h.grad] + [p.grad.clone() for p in net.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_fresh_net_follows_flax_initializers():
    """Zero biases; dense kernels at lecun_normal's scale; the recurrent
    kernels orthogonal; the same generator seed gives the same net."""
    def fresh(seed):
        return DRQNNet((13, 13, 7), 34, 21,
                       generator=torch.Generator().manual_seed(seed))
    net = fresh(2)
    eye = torch.eye(512)
    for name, p in net.state_dict().items():
        if name.endswith("bias"):
            assert not p.any(), name
        elif name.split(".")[-2] in ("hr", "hz", "hn"):
            torch.testing.assert_close(p @ p.t(), eye, atol=1e-4, rtol=0)
        else:
            fan_in = p.shape[1]
            assert abs(float(p.std()) * fan_in ** 0.5 - 1.0) < 0.15, name
    again = fresh(2).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in net.state_dict().items())


def test_init_drqn_hiddens(world):
    """One zero ``[B, cap, H]`` f32 tensor per group on the env's device,
    the JAX package's shapes."""
    pair = world["pair"]
    want = jtrain.init_drqn_hiddens(pair.jv, world["jnets"])
    got = init_drqn_hiddens(pair.tv, port_nets(world))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, CAPS[0], 512)
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        assert not g.any()


# ------------------------------------------------------------ the trainer
@pytest.fixture(scope="module")
def jax_steps(world):
    """JAX's train step per (share_acting, unroll_remat), compiled once."""
    return {form: jax.jit(jtrain.make_drqn_train_step(
        world["pair"].jv, world["jnets"], world["tx"], rollout_len=T,
        share_acting=form[0], unroll_remat=form[1])) for form in STEP_FORMS}


def _warm_hiddens(seed):
    """Nonzero initial hiddens, so the window starts from a carried
    state."""
    rng = np.random.RandomState(seed)
    return tuple((0.2 * rng.normal(size=(B, CAPS[0], 512))).astype(np.float32)
                 for _ in range(2))


def _assert_hiddens(got, want, tag):
    for g, (a, b) in enumerate(zip(got, want)):
        assert a.grad_fn is None and not a.requires_grad, tag
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg="%s group %d" % (tag, g))


@pytest.mark.parametrize("share,remat", STEP_FORMS)
def test_drqn_train_step_matches_jax(world, jax_steps, share, remat):
    """One step, eps 1.0, from nonzero hiddens: the env state exact, the
    losses and the returned (detached) hiddens within rtol 1e-5, the Adam
    moments and parameters within their tolerances."""
    js, ts = start_state(world)
    jkey, tkey = key_pair(31)
    h = _warm_hiddens(5)
    jp, jo, jstate, jh, jm = jax_steps[share, remat](
        world["jparams"], world["jparams"], world["jopts"], js,
        tuple(jnp.asarray(a) for a in h), jkey, 1.0)
    tx = ClipAdam(LR, MAX_NORM)
    nets = port_nets(world)
    step = make_drqn_train_step(world["pair"].tv, tx, rollout_len=T,
                                share_acting=share, unroll_remat=remat)
    nets, opts, tstate, th, tm = step(
        nets, port_nets(world), tuple(tx.init(n) for n in nets), ts,
        tuple(torch.from_numpy(a) for a in h), tkey, 1.0)
    assert_states_equal(tstate, jstate, "env state")
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(tm["mean_reward"].numpy(),
                               np.asarray(jm["mean_reward"]), rtol=1e-6)
    assert (tm["loss"].numpy() > 0).all()
    _assert_hiddens(th, jh, "hiddens")
    assert_optax_steps_close(nets, opts, jp, jo, lr=LR,
                             moment_rtol=MOMENT_RTOL, param_atol=PARAM_ATOL,
                             tag="drqn %s %s" % (share, remat))


def test_drqn_train_loop_refreshes_target_with_jax(world):
    """``steps_per_call=2``, ``target_update=2``, ``step0=0``: the env
    state, hiddens, losses ``[2, G]`` and parameters as JAX's loop; the
    target nets take the online weights after the second step, as JAX's
    do; from ``step0=1`` after the first, and so differ from both the
    start and the end."""
    jloop = jax.jit(jtrain.make_drqn_train_loop(
        world["pair"].jv, world["jnets"], world["tx"], steps_per_call=2,
        target_update=2, rollout_len=T))
    js, ts = start_state(world, 1)
    jkey, tkey = key_pair(32)
    jh0 = jtrain.init_drqn_hiddens(world["pair"].jv, world["jnets"])
    jp, jt, jo, jstate, jh, jm = jloop(world["jparams"], world["jparams"],
                                       world["jopts"], js, jh0, jkey, 1.0, 0)
    tx = ClipAdam(LR, MAX_NORM)
    loop = make_drqn_train_loop(world["pair"].tv, tx, steps_per_call=2,
                                target_update=2, rollout_len=T)
    for step0 in (0, 1):
        nets, tnets = port_nets(world), port_nets(world)
        h0 = init_drqn_hiddens(world["pair"].tv, nets)
        nets, tnets, opts, tstate, th, tm = loop(
            nets, tnets, tuple(tx.init(n) for n in nets), ts, h0, tkey, 1.0,
            step0)
        assert_states_equal(tstate, jstate, "env state")
        if step0 == 1:
            start = flatten_tree(world["jparams"][0])
            target, online = params_to_flax(tnets[0]), params_to_flax(nets[0])
            for other in (start, online):
                assert any(not np.array_equal(target[k], other[k])
                           for k in other)
            continue
        assert tm["loss"].shape == (2, 2)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-5)
        _assert_hiddens(th, jh, "loop hiddens")
        assert_optax_steps_close(nets, opts, jp, jo, lr=LR, steps=2,
                                 moment_rtol=MOMENT_RTOL,
                                 param_atol=PARAM_ATOL, tag="drqn loop")
        for net, tnet, jtp in zip(nets, tnets, jt):
            target, online = params_to_flax(tnet), params_to_flax(net)
            assert all(np.array_equal(target[k], online[k]) for k in online)
            want = flatten_tree(jtp)
            assert any(not np.array_equal(want[k], flatten_tree(
                world["jparams"][0])[k]) for k in want)


# ---------------------- tests/test_train_fused.py's DRQN cases, on the port
def _setup_drqn(state_size=512):
    """tests/test_train_fused.py:119-140 on the port: fresh nets (seeded
    per group), targets equal to them, plain Adam (1e-3), zero hiddens."""
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.parallel import VecGridWorld

    venv = VecGridWorld(battle.get_config(20), [6, 6], 4, device="cpu")
    spec = venv.spec

    def nets_():
        return tuple(DRQNNet(spec.view_space(g), spec.feature_size(g),
                             spec.groups[g].type.n_action,
                             state_size=state_size,
                             generator=torch.Generator().manual_seed(g))
                     for g in range(2))
    tx = ClipAdam(1e-3, float("inf"))
    nets = nets_()
    return venv, nets, nets_(), tx, init_drqn_hiddens(venv, nets)


def _one_step(venv, tx, nets, tnets, hiddens, **kw):
    """One step from fresh copies of ``nets`` at tests/test_train_fused.py's
    state and key -> (losses, flat parameters, hiddens, env state)."""
    import copy

    nets = copy.deepcopy(nets)
    step = make_drqn_train_step(venv, tx, rollout_len=3, **kw)
    nets, _, state, h2, m = step(
        nets, tnets, tuple(tx.init(n) for n in nets),
        venv.reset(trandom.PRNGKey(0)), hiddens, trandom.PRNGKey(1), 0.3)
    flat = torch.cat([p.detach().reshape(-1) for n in nets
                      for p in n.parameters()])
    return m["loss"], flat, h2, state


def test_drqn_train_step_carries_hidden():
    """tests/test_train_fused.py:119: two chained steps at eps 0.3, finite
    losses, the live agents' hiddens nonzero and detached."""
    venv, nets, tnets, tx, hiddens = _setup_drqn()
    step = make_drqn_train_step(venv, tx, rollout_len=3)
    opts = tuple(tx.init(n) for n in nets)
    state = venv.reset(trandom.PRNGKey(0))
    key = trandom.PRNGKey(1)
    for k in range(2):
        nets, opts, state, hiddens, metrics = step(
            nets, tnets, opts, state, hiddens, trandom.fold_in(key, k), 0.3)
    assert torch.isfinite(metrics["loss"]).all()
    alive = (state.active & ~state.dead)[:, :6]
    assert (hiddens[0][alive].abs() > 0).any()
    assert all(h.grad_fn is None for h in hiddens)


def test_drqn_remat_step_matches_plain():
    """tests/test_train_fused.py:175: ``unroll_remat`` False and True give
    one step's losses (rtol 1e-5) and parameters (rtol 1e-4, atol 1e-6),
    state size 32, both loss forms."""
    venv, nets, tnets, tx, hiddens = _setup_drqn(32)
    for share in (False, True):
        outs = [_one_step(venv, tx, nets, tnets, hiddens, unroll_remat=r,
                          share_acting=share) for r in (False, True)]
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=0)
        torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-4,
                                   atol=1e-6)


def test_drqn_shared_acting_matches_plain():
    """tests/test_train_fused.py:238: ``share_acting`` True and False give
    one step's losses (rtol 1e-5), parameters and hiddens (rtol 1e-4,
    atol 5e-6) and the same trajectory (positions equal), state size 32."""
    venv, nets, tnets, tx, hiddens = _setup_drqn(32)
    outs = [_one_step(venv, tx, nets, tnets, hiddens, share_acting=s)
            for s in (False, True)]
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-4, atol=5e-6)
    torch.testing.assert_close(outs[0][2][0], outs[1][2][0], rtol=1e-4,
                               atol=5e-6)
    assert torch.equal(outs[0][3].x, outs[1][3].x)


def test_drqn_split_unroll_matches_cell():
    """tests/test_train_fused.py:285: ``split_unroll`` (every ``remat``
    form) equals stepping the net frame by frame with the resets, atol
    1e-5."""
    v, f, keep, h0 = _window(6)
    net = DRQNNet((5, 5, 4), 7, 9, generator=torch.Generator().manual_seed(3))
    v, f, keep, h = (torch.from_numpy(a) for a in (v, f, keep, h0))
    ref = []
    with torch.no_grad():
        for t in range(v.shape[0]):
            h2, q = net(h, v[t], f[t])
            ref.append(q)
            h = torch.where(keep[t], h2, 0.0)
        for remat in (False, "dots", "all"):
            got = split_unroll(net, v, f, torch.from_numpy(h0), keep=keep,
                               remat=remat)
            torch.testing.assert_close(got, torch.stack(ref), atol=1e-5,
                                       rtol=0, msg=str(remat))


def test_drqn_bf16_gru_tracks_f32():
    """tests/test_train_fused.py:345: a bf16 net on the f32 net's
    parameters stays within 0.05 of it stepped and 0.08 unrolled; the
    parameters stay f32 and the outputs are f32."""
    v, f, _, _ = _window(7, state=64)
    h0 = (0.1 * np.random.RandomState(8).normal(size=(6, 64))).astype(
        np.float32)
    net32 = DRQNNet((5, 5, 4), 7, 9, state_size=64,
                    generator=torch.Generator().manual_seed(3))
    net16 = DRQNNet((5, 5, 4), 7, 9, state_size=64, dtype=torch.bfloat16)
    net16.load_state_dict(net32.state_dict())
    assert all(p.dtype == torch.float32 for p in net16.parameters())
    v, f, h0 = (torch.from_numpy(a) for a in (v, f, h0))
    with torch.no_grad():
        h32, q32 = net32(h0, v[0], f[0])
        h16, q16 = net16(h0, v[0], f[0])
        assert h16.dtype == q16.dtype == torch.float32
        torch.testing.assert_close(q16, q32, atol=0.05, rtol=0)
        torch.testing.assert_close(split_unroll(net16, v, f, h0),
                                   split_unroll(net32, v, f, h0), atol=0.08,
                                   rtol=0)
