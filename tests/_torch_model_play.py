"""The per-agent models' play loop shared by the CPU tests against the JAX
package and the card tests (JAX-free): ``tests/test_models.py:
_run_rounds``' small battle, recording what is compared, with the
near-tie rule of the action comparisons."""

import numpy as np

from magent_tpu_torch import random as trandom
from magent_tpu_torch.builtin.torch_model import round_up_pow2

# a greedy action (or a categorical draw) is compared for equality where
# its top two scores lie more than this apart
MARGIN = 1e-5
POS = ([[3, 3], [5, 5], [3, 7]], [[10, 10], [12, 12], [10, 8]])


def top_two_gap(scores):
    top = np.sort(np.asarray(scores, np.float64), axis=1)
    return top[:, -1] - top[:, -2]


def port_scores(kind, model, view, feat, ids, eps):
    """What the port model's ``infer_action`` takes the argmax of, from its
    state before the call, ``[n, n_act]`` float64, and the rows whose
    e-greedy draw explores."""
    n = len(view)
    sub = trandom.split(model.key)[1]
    if kind.startswith("a2c"):
        scores = model._scores(view, feat, sub)
        return scores.double().cpu().numpy(), np.zeros(n, bool)
    if kind == "dqn":
        q = model._q(view, feat)
    else:
        _, q = model._step(model._get_agent_states(ids), view, feat)
    k2 = trandom.split(sub)[1]
    explore = trandom.uniform(k2, (round_up_pow2(n),))[:n] < float(np.float32(eps))
    return q.double().cpu().numpy(), explore.cpu().numpy()


def place_small(env, handles):
    """The 3 + 3 agents of ``tests/test_models.py``'s small battle."""
    for h, pos in zip(handles, POS):
        env.add_agents(h, method="custom", pos=pos)


def place_blocks(n, map_size):
    """-> a ``place``: ``n`` agents a side in two square blocks at the
    map's left and right edges, mid-height."""
    side = int(np.ceil(np.sqrt(n)))

    def place(env, handles):
        y0 = (map_size - side) // 2
        for h, x0 in zip(handles, (2, map_size - 2 - side)):
            env.add_agents(h, method="custom", pos=[
                [x0 + k % side, y0 + k // side] for k in range(n)])

    return place


# a DeepQNetwork size at which two runs of train() on cuDNN's default
# algorithms differed on an H100 (at 3 agents a side and batch 4 none did)
DQN_REPRO = dict(map_size=40, n=64, batch_size=64)


def dqn_train_params(mag, model_cls, device, map_size, n, batch_size):
    """Two rounds of 6 steps of battle at ``map_size`` with ``n`` agents a
    side, each group's ``model_cls`` (``DeepQNetwork``) trained after each
    round, from fixed seeds -> every parameter of both nets."""
    np.random.seed(17)
    env = mag.GridWorld("battle", map_size=map_size, device=device)
    models = [model_cls(env, h, "m%d" % i, batch_size=batch_size,
                        memory_size=2 ** 16, target_update=3, seed=17 + i,
                        device=device)
              for i, h in enumerate(env.get_handles())]
    rec = play(mag, env, models, 0.5, rounds=2, steps=6,
               place=place_blocks(n, map_size), capacity=4 * n)
    assert all(loss != 0 for loss, _ in rec["train"])
    return [p.detach().clone() for m in models for p in m.net.parameters()]


def play(mag, env, models, eps, scores=None, ref=None, rounds=2, steps=6,
         place=place_small, capacity=100):
    """``test_models.py:_run_rounds`` recording every action, reward and
    what ``train`` returned.  The reference run passes ``scores``
    (``model, view, feat, ids -> (scores [n, n_act], explore [n])``, as
    :func:`port_scores` gives them) and records them; the run held to it
    passes that record as ``ref``: on a greedy row whose reference scores'
    top two lie within ``MARGIN`` (a tie up to rounding), its action must
    be one of the reference's tied actions, and the reference's action is
    played, so that both runs go on from the same state.  Each round starts with
    ``env.reset()`` and ``place(env, handles)``."""
    handles = env.get_handles()
    rec = dict(acts=[], rewards=[], scores=[], train=[], ties=0)
    for _ in range(rounds):
        env.reset()
        place(env, handles)
        buffers = [mag.utility.EpisodesBuffer(capacity) for _ in handles]
        done = False
        for _ in range(steps):
            if done:
                break
            all_obs = [env.get_observation(h) for h in handles]
            all_ids = [env.get_agent_id(h) for h in handles]
            acts = []
            for i, h in enumerate(handles):
                if scores is not None:
                    rec["scores"].append(scores(models[i], *all_obs[i],
                                                all_ids[i]))
                a = models[i].infer_action(all_obs[i], all_ids[i], eps=eps)
                assert a.dtype == np.int32 and a.shape == (env.get_num(h),)
                if ref is not None:
                    k = len(rec["acts"]) + len(acts)
                    sc, explore = ref["scores"][k]
                    tie = ~explore & (top_two_gap(sc) <= MARGIN)
                    picked = sc[np.arange(len(a)), a]
                    assert (picked >= sc.max(1) - MARGIN)[tie].all()
                    a = np.where(tie, ref["acts"][k], a).astype(np.int32)
                    rec["ties"] += int(tie.sum())
                acts.append(a)
                env.set_action(h, a)
            done = env.step()
            for i, h in enumerate(handles):
                rewards = env.get_reward(h)
                rec["rewards"].append(rewards)
                buffers[i].record_step(all_ids[i], all_obs[i], acts[i],
                                       rewards, env.get_alive(h))
            rec["acts"] += acts
            env.clear_dead()
        for i in range(len(handles)):
            rec["train"].append(models[i].train(buffers[i]))
    return rec
