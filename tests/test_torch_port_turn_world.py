"""Turn mode in the port's stateful and trained paths against the JAX
package, on the CPU: the golden ``turn_bodies`` scenario (1x2 bodies,
every facing) through ``tests/golden/scenarios.py``'s ``run_scenario`` on
both packages and both grid routes, and one ``dqn`` train step on a turn
config.  Tolerances as in ``test_torch_port_turn.py``: exact where the
port is on its per-direction route (the JAX package's route on the CPU),
views within atol 1e-6 on its stacked route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import magent_tpu as jmagent
from magent_tpu import gridworld as jgw
from magent_tpu.builtin.jax_model.base import (_flatten_pytree,
                                               _unflatten_pytree)
from magent_tpu.builtin.jax_model.dqn import DQNNet as JNet
from magent_tpu.parallel import train as jtrain

from magent_tpu_torch import gridworld as tgw
from magent_tpu_torch.builtin.torch_model import DQNNet, params_from_flax
from magent_tpu_torch.core import engine as tengine
from magent_tpu_torch.core import observe as tobserve
from magent_tpu_torch.core.state import state_from_numpy
from magent_tpu_torch.parallel import ClipAdam, make_dqn_train_step

from _torch_port_cases import arrays_of, assert_states_equal, key_pair
from test_torch_port_food_absorb import _sort_route, run_dual_scenario
from test_torch_port_turn import ROUTE_ATOL, _pair, batched


# --------------------------------------------------------------- golden
@pytest.mark.parametrize("route", ["quad", "sort"])
def test_turn_bodies_golden_scenario_matches_jax(route, monkeypatch):
    """The golden ``turn_bodies`` scenario (1x2 bodies, every facing, map
    24, 40 steps) through ``run_scenario`` on both packages, every call
    and the whole state compared exactly, the port's observation on its
    per-direction route (the JAX package's route on the CPU)."""
    monkeypatch.setattr(tobserve, "VMEM_IMAGE_BUDGET", 0)
    monkeypatch.setattr(tobserve, "_BAND_BUDGET", 0)
    if route == "sort":
        _sort_route(monkeypatch)
    trace, env, seen = run_dual_scenario("turn_bodies")
    assert env.t._step_fn.route == tengine._Route(grid=True,
                                                  quad=route == "quad")
    assert [f.route for f in env.t._observe_fns] == ["per_direction"] * 2
    assert env.t._grids_fn is None
    assert seen.collides > 0
    assert any((r > 0).any() for r in trace["rew_0"])  # attacks paid
    live = (env.t.state.active & ~env.t.state.dead)[0]
    assert len(np.unique(env.t.state.dir[0][live].numpy())) == 4


def test_turn_bodies_default_route_within_route_tolerance():
    """The same scenario's first 12 steps with the port on its stacked
    route: views within ROUTE_ATOL of the JAX package's, the rest exact."""
    jenv, tenv = _golden_pair()
    rng = np.random.RandomState(17)
    for step in range(12):
        for h in jenv.get_handles():
            (jv, jf), (tv, tf) = (e.get_observation(h) for e in (jenv, tenv))
            np.testing.assert_allclose(tv, jv, atol=ROUTE_ATOL, rtol=0)
            np.testing.assert_array_equal(tf, jf)
            acts = rng.randint(0, jenv.get_action_space(h)[0],
                               jenv.get_num(h)).astype(np.int32)
            for e in (jenv, tenv):
                e.set_action(h, acts)
        assert jenv.step() == tenv.step()
        for e in (jenv, tenv):
            e.clear_dead()
        assert_states_equal(tenv.state, batched(jenv.state), str(step))
    assert [f.route for f in tenv._observe_fns] == ["window_gather"] * 2


def _golden_pair():
    import magent_tpu_torch as tmagent
    from scenarios import SCENARIOS

    sc = SCENARIOS["turn_bodies"]
    envs = []
    for magent, gw in ((jmagent, jgw), (tmagent, tgw)):
        kw = {} if magent is jmagent else {"device": "cpu"}
        env = magent.GridWorld(sc["cfg"](gw, sc["map_size"]), **kw)
        env.reset()
        for h, pos in zip(env.get_handles(), sc["placements"]):
            env.add_agents(h, method="custom", pos=pos)
        envs.append(env)
    return envs


# ---------------------------------------------------------------- trainer
def test_dqn_train_step_on_turn_config_matches_jax():
    """One ``dqn`` step (whole-rollout loss, double target, eps 1.0) on the
    turn config at B=4 from flax's initial weights carried across, held as
    ``test_torch_port_train.py`` holds battle: the env state exact, the
    losses within rtol 1e-5 (here the views also differ by the hp
    quantization, ROUTE_ATOL), the Adam moments and parameters by
    ``assert_step_close``.  The remat trainer refuses turn specs, as the
    JAX package's does."""
    import optax

    from magent_tpu_torch.parallel import make_dqn_train_step_remat
    from test_torch_port_train import LR, MAX_NORM, T, assert_step_close

    p = _pair(4)
    spec = p.spec
    jnets, flats = [], []
    for g in range(2):
        net = JNet(num_actions=spec.groups[g].type.n_action)
        params = net.init(jax.random.PRNGKey(g),
                          jnp.zeros((1,) + spec.view_space(g)),
                          jnp.zeros((1, spec.feature_size(g))))["params"]
        jnets.append(net)
        flats.append(_flatten_pytree(params))
    jparams = tuple(_unflatten_pytree(f) for f in flats)
    jtx = optax.chain(optax.clip_by_global_norm(MAX_NORM), optax.adam(LR))
    jstep = jax.jit(jtrain.make_dqn_train_step(p.jv, jnets, jtx,
                                               rollout_len=T))
    jkey, tkey = key_pair(0)
    js = p.reset(jkey)
    ts = state_from_numpy(arrays_of(js), "cpu")
    jkey, tkey = key_pair(12)
    jp, jo, jstate, jm = jstep(jparams, jparams,
                               tuple(jtx.init(q) for q in jparams), js, jkey,
                               1.0)

    def nets():
        out = []
        for g, flat in enumerate(flats):
            net = DQNNet(spec.view_space(g), spec.feature_size(g),
                         spec.groups[g].type.n_action)
            net.load_state_dict(params_from_flax(flat))
            out.append(net)
        return out

    tx = ClipAdam(LR, MAX_NORM)
    online = nets()
    online, opts, tstate, tm = make_dqn_train_step(p.tv, tx, rollout_len=T)(
        online, nets(), tuple(tx.init(n) for n in online), ts, tkey, 1.0)
    assert_states_equal(tstate, jstate, "env state")
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5, atol=0)
    assert (tm["loss"].numpy() > 0).all()
    assert_step_close(online, opts, jp, jo, "turn step")
    with pytest.raises(ValueError, match="turn mode"):
        make_dqn_train_step_remat(p.tv, tx)
