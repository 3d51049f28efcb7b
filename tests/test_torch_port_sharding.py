"""The port's mesh (``magent_tpu_torch/parallel/sharding.py``) against the
JAX package's (``magent_tpu/parallel/sharding.py``, ``tests/test_sharding.py``
on the 8 virtual XLA host devices of ``conftest.py``), on the CPU.

The sharded port runs as gloo ranks, one CPU device each
(``_torch_mesh_ranks.py``, started through the port's launcher with each
rank under its own ``timeout``): a 2-rank job (dp=2: the rollout, one step
of each trainer, the fused example) and a 4-rank job (dp=4: the rollout;
dp=2 x tp=2: one step of each trainer).  Tolerances, and why:

- the shardings: equal to JAX's specs, leaf by leaf;
- the rollout: rewards within atol 1e-6 and alive exact (the JAX test's),
  the env rows after it exact against the one-process port;
- a world of one rank: bit for bit the unsharded port (no collective);
- the train steps: losses and metrics within ``RTOL`` 1e-5 (f32 sums
  taken per rank, then over the ranks), the env rows after the step exact
  (the same actions: the draws are made at the global batch), the
  gathered parameters and moments by the fused trainers' Adam rule
  (``_torch_train_checks``: moments within 1e-5 of each tensor's
  largest, parameters within 0.2 lr where the gradient's sign is
  settled, 2.2 lr elsewhere);
- an unplaced net (its parameters replicated, no ``param_sharding``) on
  a dp=2 venv: as the placed one, against the one-process step;
- the fused example: its metrics within 1e-5, its env rows exact, its
  gathered parameters and moments by the Adam rule, and rank 0's
  checkpoints exactly the gathered parameters.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from magent_tpu.builtin.config import battle as jbattle
from magent_tpu.builtin.jax_model.a2c import A2CNet as JA2CNet
from magent_tpu.builtin.jax_model.dqn import DQNNet as JDQNNet
from magent_tpu.builtin.jax_model.drqn import DRQNNet as JDRQNNet
from magent_tpu.parallel import VecGridWorld as JVecGridWorld
from magent_tpu.parallel import make_dqn_train_step as jmake_dqn_train_step
from magent_tpu.parallel import make_mesh as jmake_mesh
from magent_tpu.parallel import param_sharding as jparam_sharding
from magent_tpu.parallel import state_sharding as jstate_sharding
from jax.sharding import NamedSharding, PartitionSpec as P

import magent_tpu_torch as tmag
from magent_tpu_torch import random as rnd
from magent_tpu_torch.parallel import sharding as sh

import _torch_mesh_ranks as mr
from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_train_checks import assert_adam_steps_close, flatten_tree

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
LR = {"dqn": 1e-4, "dqnremat": 1e-4, "a2c": 1e-3, "drqn": 1e-4}


def _jvenv():
    return JVecGridWorld(jbattle.get_config(mr.MAP), mr.CAPS, n_envs=mr.B)


@pytest.fixture(scope="module")
def jax_params():
    """``tests/test_sharding.py``'s DQN parameters (``PRNGKey(g)``)."""
    spec = _jvenv().spec
    params = []
    for g in range(2):
        vh, vw, C = spec.view_space(g)
        net = JDQNNet(num_actions=spec.groups[g].type.n_action)
        params.append(net.init(
            jax.random.PRNGKey(g), jnp.zeros((1, vh, vw, C), jnp.float32),
            jnp.zeros((1, spec.feature_size(g)), jnp.float32))["params"])
    return tuple(params)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, jax_params):
    """Run the 2- and 4-rank jobs once -> {world: the ranks' outputs}."""
    flat = {}
    for g, p in enumerate(jax_params):
        for k, v in flatten_tree(jax.device_get(p)).items():
            flat["g%d/%s" % (g, k)] = v
    out = {"dirs": {}}
    for world in (2, 4):
        d = tmp_path_factory.mktemp("ranks%d" % world)
        np.savez(d / "dqn_params.npz", **flat)
        mr.run_job(world, d)
        out[world] = {case: [dict(np.load(d / ("%s_rank%d.npz" % (case, r))))
                             for r in range(world)]
                      for case in mr.JOBS[world]}
        out["dirs"][world] = d
    return out


def _flat_params(jax_params):
    return [flatten_tree(jax.device_get(p)) for p in jax_params]


# ------------------------------------------------------------ the shardings
def _port_mesh(n, tp):
    """A mesh's shape without a process group: what the rules read."""
    return sh.Mesh(n // tp, tp, 0, torch.device("cpu"), {"dp": None,
                                                        "tp": None})


def _spec_of(port_sharding, name):
    """A port :class:`Sharding` as JAX's spec of the flax leaf of ``name``
    (an ``nn.Linear`` weight is the flax kernel transposed)."""
    if port_sharding.axis is None:
        return P()
    dim = port_sharding.dim
    if name.rsplit(".", 1)[-1] == "weight":
        dim = 1 - dim
    return P(*[port_sharding.axis if i == dim else None for i in range(2)])


def _port_name(flax_path):
    *mods, leaf = flax_path.split("/")
    return ".".join(mods + ["weight" if leaf == "kernel" else leaf])


def _jax_nets():
    spec = _jvenv().spec
    vh, vw, C = spec.view_space(0)
    v = jnp.zeros((1, vh, vw, C), jnp.float32)
    f = jnp.zeros((1, spec.feature_size(0)), jnp.float32)
    n_act = spec.groups[0].type.n_action
    return spec, {
        "dqn": JDQNNet(num_actions=n_act).init(jax.random.PRNGKey(0), v, f),
        "a2c": JA2CNet(num_actions=n_act, use_comm=True).init(
            jax.random.PRNGKey(0), v, f, jnp.ones((1,), jnp.float32)),
        "drqn": JDRQNNet(num_actions=n_act).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 512)), v, f)}


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("kind", ["dqn", "a2c", "drqn"])
def test_param_sharding_matches_jax(kind, tp):
    """``param_sharding`` on each net of the port against JAX's on the same
    flax parameters (``flax_params``' names), at tp 1, 2 and 4 of 8
    devices: every leaf's spec equal, and the widths it splits."""
    _, jparams = _jax_nets()
    flat = flatten_tree(jax.device_get(jparams[kind]["params"]))
    jsh = flatten_tree(jax.tree.map(
        lambda s: s.spec, jparam_sharding(jmake_mesh(8, tp=tp),
                                          jparams[kind]["params"]),
        is_leaf=lambda x: isinstance(x, NamedSharding)))
    net = mr.fresh_nets(kind, mr.venv_of())[0] if kind != "dqn" else \
        mr.dqn_nets(mr.venv_of(), [flat, flat])[0]
    tsh = sh.param_sharding(_port_mesh(8, tp), net)
    assert sorted(tsh) == sorted(_port_name(k) for k in flat)
    split = set()
    for path in flat:
        name = _port_name(path)
        assert _spec_of(tsh[name], name) == P(*jsh[path]), (path, tp)
        if tsh[name].axis:
            split.add(name)
    want = {"dqn": {"dense_view.weight", "dense_emb.weight"},
            "a2c": {"dense_view.weight", "dense_emb.weight",
                    "dense_joint.weight", "comm.step_0_C", "comm.step_0_H",
                    "comm.step_1_C", "comm.step_1_H"},
            "drqn": {"trunk.dense_view.weight", "trunk.dense_emb.weight"}
            | {"gru.%s.weight" % k for k in ("ir", "iz", "in", "hr", "hz",
                                             "hn")}}[kind]
    assert split == (want if tp > 1 else set())


@pytest.mark.parametrize("tp,widths,tp_axis_min", [
    (2, (127, 128, 129, 130, 256), 128),
    (4, (128, 130, 132, 256, 258), 128),
    (4, (64, 96, 128, 256), 96),
    (8, (128, 256, 264), 128)])
def test_param_sharding_width_and_divisibility_edges(tp, widths, tp_axis_min):
    """JAX's rule at the edges of ``tp_axis_min`` and of divisibility, on
    flax-layout leaves ``[in, out]``, ``nn.Linear`` weights ``[out, in]``,
    1-D, 3-D and 4-D leaves: the port splits exactly the leaves JAX
    splits, along the output dim of each layout."""
    mesh = jmake_mesh(8, tp=tp)
    tree, names = {}, {}
    for w in widths:
        tree["d%d" % w] = {"kernel": np.zeros((5, w), np.float32),
                           "bias": np.zeros((w,), np.float32)}
        tree["m%d" % w] = {"C": np.zeros((w, w), np.float32)}
    tree["conv"] = {"kernel": np.zeros((3, 3, 4, 256), np.float32)}
    tree["cube"] = {"x": np.zeros((2, 4, 256), np.float32)}
    jsh = flatten_tree(jax.tree.map(
        lambda s: s.spec, jparam_sharding(mesh, tree, tp_axis_min),
        is_leaf=lambda x: isinstance(x, NamedSharding)))
    port = {}
    for path, a in flatten_tree(tree).items():
        name = _port_name(path)
        names[name] = path
        t = torch.from_numpy(a)
        port[name] = t.T if name.endswith(".weight") and t.dim() == 2 else (
            t.permute(3, 2, 0, 1) if t.dim() == 4 else t)
    tsh = sh.param_sharding(_port_mesh(8, tp), port, tp_axis_min)
    for name, path in names.items():
        assert _spec_of(tsh[name], name) == P(*jsh[path]), (path, tp)
    assert any(s.axis for s in tsh.values())


def test_state_sharding_and_replicated_match_jax():
    """Every leaf of a state: ``P("dp")`` (split on dim 0 over dp) in
    both; ``replicated``: ``P()``."""
    jv = _jvenv()
    jstate = jv.reset(jax.random.PRNGKey(0))
    jsh = jstate_sharding(jmake_mesh(8), jstate)
    state = mr.venv_of().reset(rnd.PRNGKey(0))
    mesh = _port_mesh(8, 1)
    tsh = sh.state_sharding(mesh, state)
    for f in tmag.core.state.FIELDS:
        assert getattr(jsh, f).spec == P("dp")
        assert getattr(tsh, f) == sh.Sharding(mesh, "dp", 0)
    assert all(s.axis is None for s in sh.replicated(mesh, [1, (2, 3)])[1])


def test_make_mesh_keeps_the_assertion_and_refuses_a_missing_card():
    with pytest.raises(AssertionError):
        sh.make_mesh(3, tp=2, devices="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sh.make_mesh(devices="cuda")


# ----------------------------------------------------------- world size 1
def _states_equal(a, b, rows=None):
    for f in tmag.core.state.FIELDS:
        want = getattr(b, f) if rows is None else getattr(b, f)[rows[0]:
                                                                rows[1]]
        assert torch.equal(getattr(a, f), want), f


def test_world_of_one_is_the_unsharded_port_bit_for_bit(jax_params):
    """A one-rank mesh (``make_mesh`` starting its own group): the
    rollout, and a DQN step placed by ``param_sharding``, equal the
    unsharded port exactly; ``device_put`` / ``gather`` round-trip a
    state."""
    mesh = sh.make_mesh(devices="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.size == 1
    venv, mvenv = mr.venv_of(), mr.venv_of(mesh)
    state = venv.reset(rnd.PRNGKey(0))
    placed = sh.device_put(state, sh.state_sharding(mesh, state))
    _states_equal(placed, state)
    _states_equal(sh.gather(placed, sh.state_sharding(mesh, placed)), state)
    want = mr.rollout(venv, state)
    got = mr.rollout(mvenv, mvenv.reset(rnd.PRNGKey(0)))
    _states_equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    flat = _flat_params(jax_params)
    for kind in ("dqn", "a2c", "drqn"):
        ref = mr.train_case(kind, mr.venv_of(), flat)
        out = mr.train_case(kind, mr.venv_of(mesh), flat)
        assert out[2] is not None  # placed
        for k in ref[4]:
            assert torch.equal(out[4][k], ref[4][k]), (kind, k)
        _states_equal(out[3], ref[3])
        want_p, got_p = mr.net_arrays(ref[0], ref[1]), mr.net_arrays(
            out[0], out[1], out[2])
        for k in want_p:
            np.testing.assert_array_equal(got_p[k], want_p[k], err_msg=k)


# -------------------------------------------------------------- the ranks
@pytest.fixture(scope="module")
def jax_rollout():
    """``tests/test_sharding.py``'s sharded rollout on the 8-device mesh."""
    jv = _jvenv()
    state = jv.reset(jax.random.PRNGKey(0))

    def body(carry, _):
        st, key = carry
        key, akey = jax.random.split(key)
        st, rew, alive, _ = jv.transition(st, jv.random_actions(akey))
        return (st, key), (rew, alive)

    def roll(s):
        return jax.lax.scan(body, (s, jax.random.PRNGKey(7)), None,
                            length=mr.ROLL_STEPS)[1]

    mesh = jmake_mesh(8, tp=1)
    rews, alives = jax.jit(roll)(jax.device_put(
        state, jstate_sharding(mesh, state)))
    return np.asarray(rews), np.asarray(alives)


def _rows_cat(parts, key):
    """Each dp rank's rows of ``key`` (axis 1: [T, B, ...]) in env order
    (the tp ranks of a dp row hold the same rows: one of them)."""
    by_row = {}
    for p in parts:
        by_row.setdefault(tuple(p["rows"]), p[key])
    return np.concatenate([by_row[r] for r in sorted(by_row)], axis=1)


def _assert_rows_equal(parts, state, tag):
    for p in parts:
        r0, r1 = p["rows"]
        for f in tmag.core.state.FIELDS:
            np.testing.assert_array_equal(
                p["state/" + f], getattr(state, f).numpy()[r0:r1],
                err_msg="%s %s rows %d:%d" % (tag, f, r0, r1))


@pytest.mark.parametrize("world", [2, 4])
def test_dp_rollout_matches_one_process_and_jax(jobs, jax_rollout, world):
    parts = jobs[world]["rollout"]
    assert sorted(tuple(p["rows"]) for p in parts) == [
        (i * mr.B // world, (i + 1) * mr.B // world) for i in range(world)]
    venv = mr.venv_of()
    state, rews, alives = mr.rollout(venv, venv.reset(rnd.PRNGKey(0)))
    got_r, got_a = _rows_cat(parts, "rews"), _rows_cat(parts, "alives")
    np.testing.assert_array_equal(got_r, rews.numpy())
    np.testing.assert_array_equal(got_a, alives.numpy())
    np.testing.assert_array_equal(  # the counter-based draw: global rows
        _rows_cat(parts, "fast")[0],
        venv.random_actions(rnd.PRNGKey(3), fast=True).numpy())
    np.testing.assert_allclose(got_r, jax_rollout[0], atol=1e-6)
    np.testing.assert_array_equal(got_a, jax_rollout[1])
    _assert_rows_equal(parts, state, "rollout")


@pytest.fixture(scope="module")
def jax_dqn_step(jax_params):
    """``tests/test_sharding.py``'s sharded DQN step on the (4, 2) mesh
    -> (params, adam states, metrics)."""
    jv = _jvenv()
    spec = jv.spec
    nets = [JDQNNet(num_actions=spec.groups[g].type.n_action)
            for g in range(2)]
    tx = optax.adam(1e-4)
    params = jax_params
    opts = tuple(tx.init(p) for p in params)
    tgt = jax.tree.map(lambda x: x, params)
    mesh = jmake_mesh(8, tp=2)
    step = jmake_dqn_train_step(jv, nets, tx, rollout_len=2)
    state = jv.reset(jax.random.PRNGKey(1))
    state = jax.device_put(state, jstate_sharding(mesh, state))
    params = jax.device_put(params, jparam_sharding(mesh, params))
    tgt = jax.device_put(tgt, jparam_sharding(mesh, tgt))
    opts = jax.device_put(opts, jparam_sharding(mesh, opts))
    key = jax.device_put(jax.random.PRNGKey(2), NamedSharding(mesh, P()))
    params, opts, _, metrics = jax.jit(step)(params, tgt, opts, state, key,
                                             0.5)
    return jax.device_get(params), jax.device_get(opts), \
        {k: np.asarray(v) for k, v in metrics.items()}


def _split_arrays(p, g):
    out = {}
    for kind in ("param", "mu", "nu"):
        pre = "g%d/%s/" % (g, kind)
        out[kind] = {k[len(pre):]: v for k, v in p.items()
                     if k.startswith(pre)}
    return out


def _assert_train_matches(parts, kind, ref, tag):
    """The ranks' metrics, env rows, and (every rank's gather) parameters
    and moments against the one-process step ``ref``."""
    nets, opts, _, state, metrics = ref
    for k, v in metrics.items():
        for p in parts:
            np.testing.assert_allclose(p["metric/" + k], v.numpy(),
                                       rtol=RTOL, err_msg="%s %s" % (tag, k))
    _assert_rows_equal(parts, state, tag)
    want = mr.net_arrays(nets, opts)
    lr = LR[kind]
    for g in range(2):
        w = _split_arrays(want, g)
        for p in parts:
            got = _split_arrays(p, g)
            assert_adam_steps_close(
                got["param"], w["param"], (got["mu"], got["nu"]),
                (w["mu"], w["nu"]), lr=lr, moment_rtol=1e-5,
                param_atol=0.2 * lr, tag="%s group %d" % (tag, g))


@pytest.mark.parametrize("case", ["dqn", "dqn_tp"])
def test_dqn_step_sharded_matches_one_process_and_jax(jobs, jax_params,
                                                      jax_dqn_step, case):
    """dp=2 (2 ranks) and dp=2 x tp=2 (4 ranks): losses within 1e-5 of the
    unsharded port and of JAX's (4, 2) mesh step; under tp each rank holds
    128 of ``dense_view``'s 256 rows; the gathered parameters by the Adam
    rule against both."""
    world = 4 if case == "dqn_tp" else 2
    parts = jobs[world][case]
    for p in parts:
        assert list(p["dense_view_rows"]) == [256 // (2 if world == 4
                                                     else 1)] * 2
    ref = mr.train_case("dqn", mr.venv_of(), _flat_params(jax_params))
    _assert_train_matches(parts, "dqn", ref, case)
    jparams, jopts, jmetrics = jax_dqn_step
    for k in ("loss", "mean_reward"):
        for p in parts:
            np.testing.assert_allclose(p["metric/" + k], jmetrics[k],
                                       rtol=RTOL, err_msg=k)
    for g in range(2):
        got = _split_arrays(parts[0], g)
        adam = jopts[g][0]
        assert_adam_steps_close(
            got["param"], flatten_tree(jparams[g]), (got["mu"], got["nu"]),
            (flatten_tree(adam.mu), flatten_tree(adam.nu)), lr=1e-4,
            moment_rtol=1e-5, param_atol=0.2e-4, tag="vs jax %d" % g)


@pytest.mark.parametrize("case", ["dqnremat", "a2c", "drqn", "a2c_tp",
                                  "drqn_tp"])
def test_remat_a2c_and_drqn_steps_sharded_match_one_process(jobs,
                                                            jax_params, case):
    """One DQN-remat step and one A2C (+CommNet) and DRQN step at dp=2,
    and A2C and DRQN at dp=2 x tp=2 (CommNet's and the GRU's matmuls
    column-parallel), against the one-process step."""
    kind = case.split("_")[0]
    world = 4 if case.endswith("_tp") else 2
    parts = jobs[world][case]
    for p in parts:
        assert list(p["dense_view_rows"]) == [256 // (world // 2)] * 2
    _assert_train_matches(parts, kind, mr.train_case(
        kind, mr.venv_of(), _flat_params(jax_params)), case)


def test_unplaced_net_on_a_dp_venv_matches_one_process(jobs, jax_params):
    """Nets that are not placed on the mesh (every rank holds the full
    parameters) on a dp=2 venv: the trainer sums the gradients over the
    venv's ``dp``, so the step is the one-process step and the ranks'
    parameters stay equal."""
    parts = jobs[2]["dqn_unplaced"]
    for p in parts:
        assert list(p["dense_view_rows"]) == [256] * 2
    _assert_train_matches(parts, "dqn", mr.train_case(
        "dqn", mr.venv_of(), _flat_params(jax_params)), "dqn_unplaced")
    for k in parts[0]:
        if "/param/" in k:
            np.testing.assert_array_equal(parts[1][k], parts[0][k],
                                          err_msg=k)


def test_fused_example_on_two_ranks_matches_one_process(jobs, tmp_path,
                                                         monkeypatch):
    """The fused example's ``main`` (dqn, sampled minibatch) as two gloo
    ranks against the same ``main`` alone: metrics within 1e-5, each
    rank's env rows exact, every rank's gathered parameters and moments
    by the Adam rule, and each run's checkpoints exactly its gathered
    parameters."""
    parts = jobs[2]["fused"]
    monkeypatch.chdir(tmp_path)
    ref = mr.fused_case(str(tmp_path / "one"))
    for p in parts:
        for k in ("metric/loss", "metric/mean_reward"):
            np.testing.assert_allclose(p[k], ref[k], rtol=RTOL, err_msg=k)
    merged = {}
    for p in parts:
        r0, r1 = p["rows"]
        for f in tmag.core.state.FIELDS:
            np.testing.assert_array_equal(p["state/" + f],
                                          ref["state/" + f][r0:r1],
                                          err_msg=f)
        merged[(r0, r1)] = True
    assert sorted(merged) == [(0, 4), (4, 8)]
    lr = LR["dqn"]
    for g, tag in enumerate("lr"):
        w = _split_arrays(ref, g)
        for p in parts:
            got = _split_arrays(p, g)
            assert_adam_steps_close(
                got["param"], w["param"], (got["mu"], got["nu"]),
                (w["mu"], w["nu"]), lr=lr, moment_rtol=1e-5,
                param_atol=0.2 * lr, tag="fused group %d" % g)
        path = os.path.join("save_model", "battle-fused-" + tag,
                            "tfdqn_0.npz")
        for saved, run in ((tmp_path / "one", w),
                           (jobs["dirs"][2] / "fused",
                            _split_arrays(parts[0], g))):
            with np.load(saved / path) as ckpt:
                assert sorted(ckpt) == sorted(run["param"])
                for k in ckpt:
                    np.testing.assert_array_equal(ckpt[k], run["param"][k],
                                                  err_msg=k)
