"""The per-agent models on the card (JAX-free): ``DeepQNetwork``,
``AdvantageActorCritic`` with and without CommNet and
``DeepRecurrentQNetwork`` over ``tests/_torch_model_play.py``'s small
battle on ``cuda`` against the same run on the CPU (f32, TF32 off; the
same seeds; actions equal where the CPU run's top two scores lie more than
1e-5 apart, ties held to the tied set; rewards exact; what ``train``
returns within rtol 1e-5; parameters and Adam moments by
``_torch_train_checks``' rule, moments within 1e-2 of each tensor's
largest, as the card's ReLU openings may differ from the CPU's), and a
``SubprocessModel`` whose spawned worker holds the card (its default
device): one round trip, its actions equal to an in-process model's, and
``quit()``.  Marked ``gpu``: each test decides at run time whether a card
exists and skips without one.  On a machine with an H100:
python -m pytest tests/test_torch_port_models_gpu.py -q"""

import numpy as np
import pytest
import torch

import magent_tpu_torch as tmag
from magent_tpu_torch.builtin import torch_model

from _torch_model_play import (MARGIN, place_small, play, port_scores,
                               top_two_gap)
from _torch_train_checks import assert_adam_steps_close, step_flat

pytestmark = pytest.mark.gpu

EPS = 0.5
SEED = 17
RTOL = 1e-5
MOMENT_RTOL = 1e-2
KINDS = {
    "dqn": ("DeepQNetwork", dict(batch_size=4, memory_size=256,
                                 target_update=3, train_freq=1), 1e-4),
    "a2c": ("AdvantageActorCritic", dict(use_comm=False), 1e-3),
    "a2c_comm": ("AdvantageActorCritic", dict(use_comm=True), 1e-3),
    "drqn": ("DeepRecurrentQNetwork", dict(batch_size=4, unroll_step=4,
                                           memory_size=500, target_update=2),
             1e-4),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


@pytest.mark.parametrize("kind", list(KINDS))
def test_model_gpu_matches_cpu(cuda, kind):
    cls, kwargs, lr = KINDS[kind]
    runs, models = {}, {}
    for dev in ("cpu", "cuda"):
        env = tmag.GridWorld("battle", map_size=16, device=dev)
        models[dev] = [getattr(torch_model, cls)(env, h, "%s-%d" % (kind, i),
                                                 seed=i, device=dev, **kwargs)
                       for i, h in enumerate(env.get_handles())]
        np.random.seed(SEED)
        runs[dev] = play(tmag, env, models[dev], EPS, **(
            dict(scores=lambda m, v, f, ids: port_scores(kind, m, v, f, ids,
                                                         EPS))
            if dev == "cpu" else dict(ref=runs["cpu"])))
    want, got = runs["cpu"], runs["cuda"]
    gaps = np.concatenate([np.where(ex, np.inf, top_two_gap(sc))
                           for sc, ex in want["scores"]])
    assert (gaps > MARGIN).sum() == len(gaps) - got["ties"]
    for a, b in zip(got["acts"], want["acts"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["rewards"], want["rewards"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["train"], want["train"]):
        np.testing.assert_allclose(np.hstack(a).astype(np.float64),
                                   np.hstack(b).astype(np.float64),
                                   rtol=RTOL, atol=0, err_msg=kind)
    for g, (gm, cm) in enumerate(zip(models["cuda"], models["cpu"])):
        assert gm.opt_state.count == cm.opt_state.count >= 2
        (gp, gmom), = step_flat([gm.net], [gm.opt_state])
        (cp, cmom), = step_flat([cm.net], [cm.opt_state])
        assert_adam_steps_close(gp, cp, gmom, cmom, lr=lr,
                                steps=cm.opt_state.count,
                                moment_rtol=MOMENT_RTOL, param_atol=0.2 * lr,
                                tag="%s group %d" % (kind, g))


def test_subprocess_model_holds_the_card(cuda, tmp_path):
    """The worker builds its model on the card (no ``device``: the
    default), acts as an in-process model of the same seed and weights,
    samples, trains, saves and loads, and exits on ``quit()``."""
    env = tmag.GridWorld("battle", map_size=16)
    env.reset()
    place_small(env, env.get_handles())
    h = env.get_handles()[0]
    kw = dict(batch_size=4, memory_size=256, target_update=10, train_freq=1,
              seed=3)
    sub = tmag.SubprocessModel(env, h, "hosted", 0, 100,
                               torch_model.DeepQNetwork, **kw)
    try:
        local = tmag.ProcessingModel(env, h, "local", 0, 100,
                                     torch_model.DeepQNetwork, **kw)
        assert local.model.device.type == "cuda"
        for _ in range(2):
            obs, ids = env.get_observation(h), env.get_agent_id(h)
            acts = sub.infer_action(obs, ids, "e_greedy", 0.5)
            np.testing.assert_array_equal(
                acts, local.infer_action(obs, ids, "e_greedy", 0.5))
            env.set_action(h, acts)
            env.step()
            sub.sample_step(env.get_reward(h), env.get_alive(h))
            env.clear_dead()
        loss, value = sub.train(print_every=1000)
        assert np.isfinite(loss) and np.isfinite(value)
        sub.save(str(tmp_path), 0)
        local.load(str(tmp_path), 0, name="hosted")
        sub.load(str(tmp_path), 0)
        obs, ids = env.get_observation(h), env.get_agent_id(h)
        np.testing.assert_array_equal(sub.infer_action(obs, ids, "greedy"),
                                      local.infer_action(obs, ids, "greedy"))
    finally:
        sub.quit()
    assert not sub.proc.is_alive() and sub.proc.exitcode == 0
