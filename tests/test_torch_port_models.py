"""The port's per-agent models (``DeepQNetwork``, ``AdvantageActorCritic``
with and without CommNet, ``DeepRecurrentQNetwork``) against the JAX
package's on the CPU, f32: ``tests/test_models.py:_run_rounds``' small
battle (map 16, 3 + 3 agents, 2 rounds of at most 6 steps, eps 0.5), each
model built with the same seed in both packages and the JAX model's initial
parameters carried across with ``params_from_flax``; NumPy's global RNG
reseeded before each package's run (``EpisodesBuffer``'s permutation, the
replay draws).  Also the bundled trusty checkpoints at battle map 125,
checkpoints carried across the packages both ways, and ``_eval`` on an
eval set.

Tolerances, and why:
- actions: equal wherever the top two of JAX's Q values (or of its
  categorical draw's ``gumbel + log(policy)`` scores) lie more than
  ``MARGIN`` 1e-5 apart, and every action compared for equality is
  asserted to clear it, so equality is never luck: the port's convs, GEMMs
  and ``log`` round differently from XLA's in the last bits.  On a greedy
  row within the margin (a tie up to rounding) the port's action must be
  one of JAX's tied ones, and JAX's is played in both runs;
- rewards, observations in the replay: exact (the env is bit-equal);
  DRQN hidden states: within ``ATOL`` 1e-5;
- what ``train`` returns (losses, targets, values): rtol ``RTOL`` 1e-5;
- parameters and Adam moments: ``_torch_train_checks``' rule (moments
  within ``MOMENT_RTOL`` of each tensor's largest; parameters within
  ``0.2 lr`` per step where the gradient's sign is settled, ``2 lr`` more
  elsewhere);
- checkpoints: bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import magent_tpu as jmag
from magent_tpu.builtin import jax_model

import magent_tpu_torch as tmag
from magent_tpu_torch.builtin import torch_model

from _torch_model_play import MARGIN, play, top_two_gap
from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_train_checks import assert_optax_steps_close, flatten_tree

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
ATOL = 1e-5
MOMENT_RTOL = 1e-5
SEED = 17
EPS = 0.5

# kind -> (class name, constructor arguments, learning rate)
KINDS = {
    "dqn": ("DeepQNetwork", dict(batch_size=4, memory_size=256,
                                 target_update=3, train_freq=1), 1e-4),
    "a2c": ("AdvantageActorCritic", dict(use_comm=False), 1e-3),
    "a2c_comm": ("AdvantageActorCritic", dict(use_comm=True), 1e-3),
    "drqn": ("DeepRecurrentQNetwork", dict(batch_size=4, unroll_step=4,
                                           memory_size=500, target_update=2),
             1e-4),
}


@pytest.fixture(scope="module")
def envs():
    """The small battle in both packages."""
    return {"jax": jmag.GridWorld("battle", map_size=16),
            "port": tmag.GridWorld("battle", map_size=16, device="cpu")}


def jax_scores(kind, jm, view, feat, ids):
    """What JAX's ``infer_action`` takes the argmax of, from its state
    before the call, ``[n, n_act]`` float64, and the rows whose e-greedy
    draw explores (their action is ``randint``'s, bit-equal)."""
    n = len(view)
    padded = jax_model.base.round_up_pow2(n)
    sub = jax.random.split(jm.key)[1]
    if kind in ("dqn", "drqn"):
        if kind == "dqn":
            q = jm._q_fn(jm.params, view, feat)
        else:
            _, q = jm.net.apply({"params": jm.params},
                                jm._get_agent_states(ids), view, feat)
        k2 = jax.random.split(sub)[1]
        explore = np.asarray(jax.random.uniform(k2, (padded,)))[:n] < EPS
        return np.asarray(q, np.float64), explore
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((padded - n,) + a.shape[1:], a.dtype)])
    mask = np.zeros(padded, np.float32)
    mask[:n] = 1.0
    policy, _ = jm.net.apply({"params": jm.params}, pad(view), pad(feat),
                             mask)
    noise = jax.random.gumbel(sub, policy.shape)
    return (np.asarray((noise + jnp.log(policy))[:n], np.float64),
            np.zeros(n, bool))


def model_pair(kind, envs):
    """Per group: the JAX model and the port's, the port's loaded with the
    JAX model's initial parameters."""
    cls, kwargs, _ = KINDS[kind]
    jms, tms = [], []
    for i, (jh, th) in enumerate(zip(envs["jax"].get_handles(),
                                     envs["port"].get_handles())):
        jm = getattr(jax_model, cls)(envs["jax"], jh, "%s-%d" % (kind, i),
                                     seed=i, **kwargs)
        tm = getattr(torch_model, cls)(envs["port"], th, "%s-%d" % (kind, i),
                                       seed=i, device="cpu", **kwargs)
        tm.set_params(flatten_tree(jax.device_get(jm.params)))
        jms.append(jm)
        tms.append(tm)
    return jms, tms


@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_jax(kind, envs):
    jms, tms = model_pair(kind, envs)
    np.random.seed(SEED)
    want = play(jmag, envs["jax"], jms, EPS, scores=lambda m, v, f, ids:
                jax_scores(kind, m, v, f, ids))
    np.random.seed(SEED)
    got = play(tmag, envs["port"], tms, EPS, ref=want)

    # every action compared for equality clears the margin (or explored)
    gaps = np.concatenate([np.where(ex, np.inf, top_two_gap(sc))
                           for sc, ex in want["scores"]])
    compared = gaps > MARGIN
    assert compared.sum() == len(gaps) - got["ties"]
    assert np.isfinite(gaps[compared]).sum() > 12, kind  # greedy rows
    assert len(got["acts"]) == len(want["acts"])
    for a, b in zip(got["acts"], want["acts"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["rewards"], want["rewards"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["train"], want["train"]):
        np.testing.assert_allclose(np.hstack(a).astype(np.float64),
                                   np.hstack(b).astype(np.float64),
                                   rtol=RTOL, atol=0, err_msg=kind)

    lr = KINDS[kind][2]
    for g, (jm, tm) in enumerate(zip(jms, tms)):
        steps = int(jm.opt_state[1][0].count)
        assert steps >= 2, (kind, g, steps)
        assert_optax_steps_close(
            [tm.net], [tm.opt_state], [jm.params], [jm.opt_state], lr=lr,
            steps=steps, moment_rtol=MOMENT_RTOL, param_atol=0.2 * lr,
            tag="%s group %d" % (kind, g))
        if kind == "dqn":
            assert tm.replay_buf_len == jm.replay_buf_len > 0
            for name in ("view", "feature", "action", "reward", "terminal",
                         "mask"):
                np.testing.assert_array_equal(
                    getattr(tm, "replay_buf_" + name).buffer[
                        :tm.replay_buf_len],
                    getattr(jm, "replay_buf_" + name).buffer[
                        :jm.replay_buf_len], err_msg=name)
        if kind == "drqn":
            assert tm.replay_buffer_lens == jm.replay_buffer_lens
            for te, je in zip(tm.replay_buffer, jm.replay_buffer):
                for a, b in zip(te, je):
                    np.testing.assert_array_equal(a, b)
            assert sorted(tm.agent_states) == sorted(jm.agent_states)
            assert len(jm.agent_states) > 0
            for k, s in jm.agent_states.items():
                np.testing.assert_allclose(tm.agent_states[k], s, rtol=0,
                                           atol=ATOL)


def trusty_path(side):
    return "%s/trusty-battle-game-%s/tfdqn_0.npz" % (
        tmag.utility.bundled_model_dir(), side)


def test_trusty_checkpoints_give_jax_greedy_actions():
    """Both packages load the bundled ``tfdqn_0.npz`` of each side and act
    greedily on the same views of train_battle's map 125, 2 x 625 armies
    (``examples/train_battle.py`` ``generate_map``'s first round)."""
    env = tmag.GridWorld("battle", map_size=125, device="cpu")
    handles = env.get_handles()
    env.reset()
    side = int(np.sqrt(int(125 * 125 * 0.04))) * 2
    y0 = (125 - side) // 2
    for h, x0 in zip(handles, (125 // 2 + 3, 125 // 2 - 3 - side)):
        env.add_agents(h, method="custom", pos=[
            [x, y, 0] for x in range(x0, x0 + side, 2)
            for y in range(y0, y0 + side, 2)])
    root = tmag.utility.bundled_model_dir()
    for h, tag in zip(handles, "lr"):
        view, feat = env.get_observation(h)
        ids = env.get_agent_id(h)
        assert len(view) == 625
        jm = jax_model.DeepQNetwork(env, h, "j", memory_size=64)
        tm = torch_model.DeepQNetwork(env, h, "t", memory_size=64,
                                      device="cpu")
        for m in (jm, tm):
            m.load(root, 0, name="trusty-battle-game-" + tag)
        gaps = top_two_gap(jm._q_fn(jm.params, view, feat))
        assert gaps.min() > MARGIN, float(gaps.min())
        want = jm.infer_action((view, feat), ids, policy="greedy")
        got = tm.infer_action((view, feat), ids, policy="greedy")
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) > 1


@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpoints_cross_packages_bit_for_bit(kind, envs, tmp_path):
    """JAX save -> port load, and port save -> JAX load, exact; the file
    names are the JAX package's."""
    jms, tms = model_pair(kind, envs)
    jm, tm = jms[0], tms[1]  # the other seed: the load must overwrite
    prefix = jm.subclass_name
    assert tm.subclass_name == prefix
    jm.save(str(tmp_path), 4)
    assert (tmp_path / jm.name / ("%s_4.npz" % prefix)).exists()
    tm.load(str(tmp_path), 4, name=jm.name)
    want = flatten_tree(jax.device_get(jm.params))
    got = tm.get_params()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # the port's own weights back into JAX
    tms[0].save(str(tmp_path), 5)
    jms[1].load(str(tmp_path), 5, name=tms[0].name)
    back = flatten_tree(jax.device_get(jms[1].params))
    mine = tms[0].get_params()
    assert sorted(back) == sorted(mine)
    for k in mine:
        np.testing.assert_array_equal(back[k], mine[k], err_msg=k)
    assert torch_model.latest_epoch(str(tmp_path), tms[0].name) == 5


@pytest.mark.parametrize("kind", ["dqn", "drqn"])
def test_eval_obs_matches_jax(kind, envs):
    """``_eval`` with an eval set: DQN's mean max-Q of the online net, the
    DRQN's mean target-net Q from a zero state (``tests/test_models.py::
    test_drqn_eval_obs_used``), against JAX within rtol 1e-5; without one,
    the fallback."""
    jms, tms = model_pair(kind, envs)
    jm, tm = jms[0], tms[0]
    rng = np.random.RandomState(1)
    ev = rng.rand(5, *jm.view_space).astype(np.float32)
    ef = rng.rand(5, *jm.feature_space).astype(np.float32)
    jm.eval_obs = tm.eval_obs = (ev, ef)
    np.testing.assert_allclose(tm._eval(123.0), jm._eval(123.0), rtol=RTOL)
    jm.eval_obs = tm.eval_obs = None
    assert tm._eval(123.0) == jm._eval(123.0) == 123.0
