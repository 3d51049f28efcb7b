"""The port's fused DRQN train step against the benchmark's plain float32
reference (``h100bench/reference/drqn.py``) on the CPU, f32, at a small
size: battle map 32, caps [8, 8], B=2, a GRU of 32, a window of 3.  Each
group's net takes the reference's seeded weights; the step under test is
the second from zero GRU states, so its window starts from carried,
non-zero states.

The reference replays the program's own stored window (views, features,
actions, liveness): its unroll gives the Q values and the carried states,
its TD sum the loss, autograd the gradient through time, its clip and
Adam the update.  Tolerances, and why: the two sides compute the same
float32 operations in other orders (the port's gates add its bias after
the matmul inside ``F.linear`` or after ``matmul``), so Q values and states
agree to rtol 1e-5, atol 1e-6; the loss to rtol 1e-5; each gradient to
rtol 1e-4, atol 1e-7 (a backward sums more terms); the clip and Adam
update, taken by both from the program's gradient (a weight whose
gradient is near Adam's epsilon turns the gradients' rounding gap into a
step gap up to ``2e-3 * lr``), to atol ``1e-3 * lr``: the float32
rounding of the updated weights (a weight near 0.5 rounds by 3e-8)."""

import copy

import pytest
import torch

from h100bench import flops_drqn
from h100bench.reference import drqn as refdrqn
from magent_tpu_torch import random as rnd
from magent_tpu_torch.builtin.config import battle
from magent_tpu_torch.builtin.torch_model import DRQNNet
from magent_tpu_torch.parallel import (ClipAdam, VecGridWorld,
                                       init_drqn_hiddens, make_drqn_train_step)

MAP, CAPS, B, T, H = 32, [8, 8], 2, 3, 32
LR, CLIP, GAMMA, EPS = 1e-4, 5.0, 0.99, 0.3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorded(ClipAdam):
    """``ClipAdam`` keeping each net's gradient before its step."""

    def __init__(self):
        super().__init__(LR, CLIP)
        self.grads = []

    def update(self, net, state):
        self.grads.append({k: p.grad.clone() for k, p in net.named_parameters()})
        return super().update(net, state)


def _setup(share_acting, use_dueling):
    venv = VecGridWorld(battle.get_config(MAP), CAPS, n_envs=B, device="cpu")
    spec = venv.spec
    net_cfg = dict(dense=256, state_size=H, dueling=use_dueling)
    gen = torch.Generator().manual_seed(5)
    nets, params = [], []
    for g in range(spec.n_groups):
        shapes = refdrqn.param_shapes(spec.view_space(g), spec.feature_size(g),
                                      spec.groups[g].type.n_action, net_cfg)
        p = refdrqn.init_params(shapes, gen, "cpu")
        net = DRQNNet(spec.view_space(g), spec.feature_size(g),
                      spec.groups[g].type.n_action, use_dueling=use_dueling,
                      state_size=H)
        net.load_state_dict(p)
        nets.append(net)
        params.append(p)
    tx = _Recorded()
    step = make_drqn_train_step(venv, tx, gamma=GAMMA, rollout_len=T,
                                share_acting=share_acting)
    targets = tuple(copy.deepcopy(n) for n in nets)
    opts = tuple(tx.init(n) for n in nets)
    state = venv.reset(rnd.PRNGKey(3))
    hiddens = init_drqn_hiddens(venv, nets)
    # a first step, so that the window under test starts from carried states
    nets, opts, state, hiddens, _ = step(tuple(nets), targets, opts, state,
                                         hiddens, rnd.PRNGKey(4), EPS)
    for t, n in zip(targets, nets):  # the targets lag one update behind
        assert not torch.equal(t.value.weight, n.value.weight)
    tx.grads.clear()
    return venv, tx, step, nets, targets, opts, state, hiddens


@pytest.mark.parametrize("use_dueling", [True, False])
@pytest.mark.parametrize("share_acting", [True, False])
def test_the_drqn_step_equals_the_plain_reference(share_acting, use_dueling):
    venv, tx, step, nets, targets, opts, state, h0 = _setup(share_acting,
                                                            use_dueling)
    spec = venv.spec
    before = [{k: v.detach().clone() for k, v in n.state_dict().items()}
              for n in nets]
    mu0 = [[m.clone() for m in o.mu] for o in opts]
    nu0 = [[v.clone() for v in o.nu] for o in opts]
    key = rnd.PRNGKey(9)
    _, rkey = rnd.split(key).unbind(-2)
    _, h_end, traj = step.rollout(nets, state, h0, rkey, EPS)
    opts2, metrics = step.learn(nets, targets, opts, h0, traj)
    for g in range(spec.n_groups):
        o, cap = spec.groups[g].offset, spec.groups[g].cap
        sl = slice(o, o + cap)
        p = {k: v.clone().requires_grad_(True) for k, v in before[g].items()}
        tp = {k: v.detach() for k, v in targets[g].state_dict().items()}
        views = traj["views"][g].reshape((T, B * cap) + spec.view_space(g))
        feats = traj["feats"][g].reshape(T, B * cap, -1)
        alive, done = traj["alive"][..., sl], traj["done"][:, :, None]
        keep = (alive & ~done).reshape(T, -1)
        hs = h0[g].reshape(-1, H)
        qs, h_last = refdrqn.unroll(p, hs, views, feats, keep)
        # the acting Q values of the window and the states the step
        # carries out of it
        torch.testing.assert_close(traj["qs"][g].reshape(qs.shape).detach(),
                                   qs.detach(), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(h_end[g].reshape(-1, H), h_last.detach(),
                                   rtol=1e-5, atol=1e-6)
        with torch.no_grad():
            tqs = refdrqn.unroll(tp, hs, views, feats, keep)[0]
        act = traj["actions"][..., sl].reshape(T, -1)
        rew = traj["rewards"][..., sl].reshape(T, -1)
        term = (~alive | done).reshape(T, -1)
        mask = traj["alive_in"][..., sl].reshape(T, -1)
        total, denom = refdrqn.td_sum(qs, tqs, act, rew, term, mask, GAMMA)
        loss = total / denom.clamp_min(1.0)
        torch.testing.assert_close(metrics["loss"][g], loss.detach(),
                                   rtol=1e-5, atol=0)
        names = list(p)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        for k, gr in zip(names, grads):
            torch.testing.assert_close(tx.grads[g][k], gr,
                                       rtol=1e-4, atol=1e-7, msg=lambda m, k=k: "%s: %s" % (k, m))
        adam = refdrqn.Adam(p, LR, CLIP)
        adam.count = opts[g].count - 1
        adam.mu = dict(zip(names, mu0[g]))
        adam.nu = dict(zip(names, nu0[g]))
        adam.step(p, tx.grads[g])  # clip and Adam on the program's gradient
        after = nets[g].state_dict()
        for k in names:
            torch.testing.assert_close(after[k] - before[g][k],
                                       p[k].detach() - before[g][k],
                                       rtol=0, atol=1e-3 * LR, msg=lambda m, k=k: "%s: %s" % (k, m))
    assert all(o.count == 2 for o in opts2)


def test_the_drqn_flop_count_by_hand():
    """At the test's size: views 13 x 13 x 7 (1,183 inputs), 34 features,
    21 actions, dense 256, a GRU of 32, dueling heads; B=2 worlds of 8
    agents per group over a window of 3."""
    per = flops_drqn.drqn_forward((13, 13, 7), 34, 21,
                                  dict(dense=256, state_size=H, dueling=True))
    assert per == dict(dense_view=605_696, dense_emb=17_408,
                       gru_in=3 * 2 * 512 * 32, gru_state=3 * 2 * 32 * 32,
                       heads=2 * 32 * 22,
                       total=605_696 + 17_408 + 98_304 + 6_144 + 1_408)
    n = B * 8
    # forward and target unroll: 3 frames each; backward over 2 frames,
    # the first without the state projections' input gradient
    f = 728_960
    assert flops_drqn.drqn_train_step(per, n, T) == n * (
        3 * f + 3 * f + 2 * (2 * f - 605_696 - 17_408) - 6_144)
