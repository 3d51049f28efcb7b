"""The port's ``train_battle_fused`` example against the JAX package's
(``examples/train_battle_fused.py``, loaded with ``importlib``), on the
CPU, f32: per algorithm, the port's ``main`` at one call of one train
step against the JAX example's ``main`` (its calls recorded through its
``jax.jit``), from the JAX example's initial parameters carried across
(flax's initializers on ``fold_in(PRNGKey(0), g)``, which the port's
``fresh_net`` does not draw).

Tolerances, and why:
- the call's round and eps (0.2 at one round), the reset state and the
  state after the call: exact (the Q trainers' greedy actions and A2C's
  draws are equal at this seed; the keys are bit-equal);
- losses and mean rewards: ``RTOL`` 1e-5 (f32 sums in other orders: the
  trainers' tolerance);
- the parameters and Adam moments after the call: the fused trainers'
  rule (``_torch_train_checks``: moments within 1e-5 of each tensor's
  largest, parameters within 0.2 lr where the gradient's sign is settled,
  2.2 lr elsewhere), and the saved checkpoints' names, with values equal
  to the port's parameters and within that rule of the JAX example's.
"""

import importlib
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest

import magent_tpu as jmag

import magent_tpu_torch as tmag

from _torch_port_cases import assert_states_equal
from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_train_checks import assert_optax_steps_close, flatten_tree

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "train_battle_fused.py")
RTOL = 1e-5


class _JitRecorder:
    """Stands in for the ``jax`` module of a JAX example: ``jit`` records
    each jitted call's function, inputs and outputs in ``calls``."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)

        def run(*args):
            out = jitted(*args)
            self.calls.append((fn, args, out))
            return out

        return run


# B=8: the JAX example shards its envs over the 8 host devices of the tests
FUSED_ARGV = ["--n_round", "1", "--steps_per_call", "1", "--map_size", "20",
              "--agents_per_side", "6", "--n_envs", "8", "--rollout_len",
              "3", "--train_minibatch", "32"]
FUSED_MOMENT_RTOL, FUSED_LR = 1e-5, {"a2c": 1e-3}


@pytest.mark.parametrize("alg", ["dqn", "dqn_remat", "drqn", "a2c"])
def test_train_battle_fused_matches_jax(alg, tmp_path, monkeypatch):
    """The port's example through ``main`` (one call of one train step)
    against the JAX example's ``main``, from the JAX example's initial
    parameters (flax's initializers on ``fold_in(PRNGKey(0), g)``, which
    the port's ``fresh_net`` does not draw) carried into the port's nets
    and target nets by a wrapped ``setup``: the call's round and eps, the
    reset state and the state after the call, losses and mean rewards,
    the trained parameters, and the saved checkpoints' names and
    values."""
    from magent_tpu_torch.builtin.torch_model import (params_from_flax,
                                                      params_to_flax)

    monkeypatch.setattr(jmag.utility, "init_logger", lambda _: None)
    monkeypatch.setattr(tmag.utility, "init_logger", lambda _: None)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    monkeypatch.chdir(jdir)
    spec = importlib.util.spec_from_file_location("jax_fused_example",
                                                  EXAMPLE)
    jfused = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jfused)
    rec = _JitRecorder()
    monkeypatch.setattr(jfused, "jax", rec)
    monkeypatch.setattr(sys, "argv", ["train_battle_fused.py", "--alg", alg]
                        + FUSED_ARGV)
    jfused.main()
    (_, _, jreset), (_, jin, jout) = rec.calls

    fused = importlib.import_module(
        "magent_tpu_torch.examples.train_battle_fused")
    setup, made, calls = fused.setup, [], []
    env_i = 2 if alg == "a2c" else 3

    def setup_from_jax(args):
        ex = setup(args)
        assert_states_equal(ex.carry[env_i], jreset, "reset")
        for slot in (0,) if alg == "a2c" else (0, 1):
            for net, jp in zip(ex.carry[slot], jax.device_get(jin[slot])):
                net.load_state_dict(params_from_flax(flatten_tree(jp)))
        call = ex.call

        def recorded(c, eps):
            calls.append((c, eps, call(c, eps)))
            return calls[-1][-1]

        ex.call = recorded
        made.append(ex)
        return ex

    monkeypatch.setattr(fused, "setup", setup_from_jax)
    monkeypatch.chdir(tdir)
    fused.main(["--alg", alg, "--device", "cpu"] + FUSED_ARGV)
    ex, = made
    (c, eps, metrics), = calls
    # the loops' eps: after the key (drqn: the hiddens, then the key)
    assert c == 0 and (alg == "a2c" or eps == float(jin[-2]))
    jm = jout[-1]
    for name in ("loss", "mean_reward"):
        np.testing.assert_allclose(metrics[name].numpy(),
                                   np.asarray(jm[name]), rtol=RTOL,
                                   err_msg=name)
    assert_states_equal(ex.carry[env_i], jout[env_i], "after the call")
    lr = FUSED_LR.get(alg, 1e-4)
    assert_optax_steps_close(ex.carry[0], ex.carry[env_i - 1],
                             jax.device_get(jout[0]), jout[env_i - 1],
                             lr=lr, moment_rtol=FUSED_MOMENT_RTOL,
                             param_atol=0.2 * lr, tag=alg)
    sub = fused.SUBCLASS[alg]
    for g, tag in enumerate("lr"):
        path = os.path.join("save_model", "battle-fused-" + tag,
                            sub + "_0.npz")
        with np.load(path) as got, np.load(jdir / path) as want:
            assert sorted(got) == sorted(want)
            mine = params_to_flax(ex.carry[0][g])
            for k in want:
                np.testing.assert_array_equal(got[k], mine[k])
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=(2 * lr + 0.2 * lr))
