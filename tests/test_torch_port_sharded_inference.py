"""``DeepQNetwork.shard_inference`` and ``num_gpu`` of the port
(``builtin/torch_model/dqn.py``) against the JAX model's
(``tests/test_sharded_inference.py``), on the CPU: the port's model is
given eight CPU devices (``devices=["cpu"] * 8``), the counterpart of the
8 virtual XLA host devices ``conftest.py`` gives the JAX model, and
carries the JAX model's weights (``set_params``).

Tolerances: actions exact, greedy and at eps 0.3, sharded and not, in
both packages (the same threefry draws at the same padded shapes; the
rows' Q values clear of ties at this seed)."""

import jax
import numpy as np
import pytest

import magent_tpu as jmag
from magent_tpu.builtin.jax_model import DeepQNetwork as JDeepQNetwork

import magent_tpu_torch as tmag
from magent_tpu_torch.builtin.torch_model import DeepQNetwork

from _torch_port_cases import one_torch_thread  # noqa: F401
from _torch_train_checks import flatten_tree

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPUS = ["cpu"] * 8


def _models_and_obs(n=300, **kwargs):
    """The JAX model and the port's (on the JAX model's weights), and
    ``n`` random observation rows."""
    jenv = jmag.GridWorld("battle", map_size=16)
    tenv = tmag.GridWorld("battle", map_size=16, device="cpu")
    jm = JDeepQNetwork(jenv, jenv.get_handles()[0], "shinf",
                       memory_size=512, **kwargs)
    tm = DeepQNetwork(tenv, tenv.get_handles()[0], "shinf", memory_size=512,
                      device="cpu", devices=CPUS, **kwargs)
    tm.set_params(flatten_tree(jax.device_get(jm.params)))
    rng = np.random.RandomState(0)
    view = rng.rand(n, *tm.view_space).astype(np.float32)
    feat = rng.rand(n, *tm.feature_space).astype(np.float32)
    return jm, tm, view, feat


def _acts(model, view, feat, key0, **kw):
    """Greedy and eps-0.3 actions of ``model``, each from the key
    ``key0``."""
    ids = np.arange(len(view))
    model.key = key0
    greedy = model.infer_action((view, feat), ids, policy="greedy", **kw)
    model.key = key0
    return greedy, model.infer_action((view, feat), ids, eps=0.3, **kw)


@pytest.mark.parametrize("n_dev", [8, 3])
def test_sharded_inference_matches_unsharded_and_jax(n_dev):
    """``infer_batch_size=256`` forces chunking (300 rows -> 256 + 44):
    the sharded actions equal the single path's and the JAX model's
    sharded ones.  With 3 devices the padded chunk (256, 64) rounds up to
    a multiple of 3 (258, 66), which shifts the e-greedy draw's shape in
    both packages alike."""
    jm, tm, view, feat = _models_and_obs(infer_batch_size=256)
    jkey0, tkey0 = jm.key, tm.key
    ref = _acts(tm, view, feat, tkey0)
    jref = _acts(jm, view, feat, jkey0)
    for a, b in zip(ref, jref):
        np.testing.assert_array_equal(a, b)

    tm.shard_inference(n_dev)
    jm.shard_inference(n_dev)
    assert tm._infer_devices == n_dev and len(tm._replicas) == n_dev
    got, jgot = _acts(tm, view, feat, tkey0), _acts(jm, view, feat, jkey0)
    np.testing.assert_array_equal(got[0], ref[0])
    for a, b in zip(got, jgot):
        np.testing.assert_array_equal(a, b)
    if n_dev == 8:  # the pads divide by 8: the draws are the single path's
        np.testing.assert_array_equal(got[1], ref[1])


def test_num_gpu_kwarg_enables_sharding():
    """The reference's ``num_gpu`` constructor knob shards the inference;
    ``shard_inference(1)`` goes back to the single path."""
    jm, tm, view, feat = _models_and_obs(n=64, num_gpu=4)
    assert tm._infer_devices == 4 == jm._infer_devices
    ids = np.arange(64)
    acts = tm.infer_action((view, feat), ids, policy="greedy")
    np.testing.assert_array_equal(
        acts, jm.infer_action((view, feat), ids, policy="greedy"))
    tm.shard_inference(1)
    assert tm._replicas is None and tm._infer_devices == 1
    np.testing.assert_array_equal(
        acts, tm.infer_action((view, feat), ids, policy="greedy"))


def test_shard_inference_caps_at_available_devices():
    jm, tm, view, feat = _models_and_obs(n=40)
    tm.shard_inference(999)
    assert tm._infer_devices == 8  # the devices it was given
    acts = tm.infer_action((view, feat), np.arange(40), policy="greedy")
    assert acts.shape == (40,)
    jm.shard_inference(999)
    np.testing.assert_array_equal(
        acts, jm.infer_action((view, feat), np.arange(40), policy="greedy"))


def test_default_devices_on_the_cpu_are_the_models_one():
    """Without ``devices``, a CPU model's local devices are its own one:
    ``num_gpu=4`` caps at the single path."""
    tenv = tmag.GridWorld("battle", map_size=16, device="cpu")
    tm = DeepQNetwork(tenv, tenv.get_handles()[0], "one", memory_size=64,
                      device="cpu", num_gpu=4)
    assert tm.local_devices() == [tm.device]
    assert tm._infer_devices == 1 and tm._replicas is None


def test_replicas_follow_training():
    """The replicas take the online weights at every call: after
    ``set_params`` with other weights the sharded actions follow them."""
    jm, tm, view, feat = _models_and_obs(n=100)
    tm.shard_inference(4)
    ids = np.arange(100)
    before = tm.infer_action((view, feat), ids, policy="greedy")
    flat = {k: -v for k, v in tm.get_params().items()}
    tm.set_params(flat)
    after = tm.infer_action((view, feat), ids, policy="greedy")
    tm.shard_inference(1)
    np.testing.assert_array_equal(
        after, tm.infer_action((view, feat), ids, policy="greedy"))
    assert (after != before).any()
