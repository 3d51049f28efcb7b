"""The second backend's advantage actor-critic (port of
``magent_tpu/builtin/torch_model/a2c.py``; capability parity with the
reference's MXNet A2C, python/magent/builtin/mx_model/a2c.py).

A shared dense trunk, softmax policy and value heads, one policy-gradient
step on the whole buffer's bootstrapped episode returns with value and
entropy terms: the JAX package's ``tha2c`` model, run on ``device``.  The
categorical draw takes one uniform per row from the model's host
``np.random.RandomState(seed)``, as there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import TorchBaseModel, build_net


class TorchA2CNet(nn.Module):
    def __init__(self, view_space, feature_space, num_actions):
        super().__init__()
        vh, vw, C = view_space
        self.dense_view = nn.Linear(vh * vw * C, 256)
        self.dense_emb = nn.Linear(feature_space[0], 256)
        self.dense_joint = nn.Linear(512, 512)
        self.policy = nn.Linear(512, num_actions)
        self.value = nn.Linear(512, 1)

    def forward(self, view, feature):
        h = torch.cat([F.relu(self.dense_view(view.flatten(1))),
                       F.relu(self.dense_emb(feature))], dim=1)
        h = F.relu(self.dense_joint(h))
        policy = torch.clamp(F.softmax(self.policy(h), dim=1),
                             1e-10, 1.0 - 1e-10)
        return policy, self.value(h)[:, 0]


class AdvantageActorCritic(TorchBaseModel):
    """Same arguments as the JAX package's ``tha2c`` model, plus ``device``
    (``None``: the card)."""

    def __init__(self, env, handle, name, learning_rate=1e-3,
                 batch_size=64, reward_decay=0.99, eval_obs=None,
                 train_freq=1, value_coef=0.1, ent_coef=0.08,
                 custom_view_space=None, custom_feature_space=None,
                 seed=0, device=None, **kwargs):
        TorchBaseModel.__init__(self, env, handle, name, "tha2c",
                                device=device)

        self.view_space = custom_view_space or env.get_view_space(handle)
        self.feature_space = (custom_feature_space
                              or env.get_feature_space(handle))
        self.num_actions = env.get_action_space(handle)[0]
        self.gamma = reward_decay
        self.value_coef = value_coef
        self.ent_coef = ent_coef
        self.train_ct = 0

        self.net = build_net(TorchA2CNet, self.view_space, self.feature_space,
                             self.num_actions, seed=seed, device=self.device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=learning_rate)
        self._rng = np.random.RandomState(seed)

    # ------------------------------------------------------------ inference
    def infer_action(self, raw_obs, ids, *args, **kwargs):
        view, feature = raw_obs[0], raw_obs[1]
        n = len(view)
        if n == 0:
            return np.empty(0, np.int32)
        with torch.no_grad():
            policy, _ = self.net(self._tensor(view), self._tensor(feature))
        p = policy.cpu().numpy()
        # vectorized categorical sample (one uniform per row)
        cdf = np.cumsum(p, axis=1)
        u = self._rng.rand(n, 1) * cdf[:, -1:]
        return (cdf < u).sum(axis=1).astype(np.int32).clip(
            0, self.num_actions - 1)

    # ------------------------------------------------------------- training
    def train(self, sample_buffer, print_every=1000, **kwargs):
        episodes = list(sample_buffer.episodes())
        n = sum(len(e.rewards) for e in episodes)
        if n == 0:
            return [0, 0, 0], 0

        views, feats, acts, rets = [], [], [], []
        with torch.no_grad():
            for e in episodes:
                # bootstrap the tail from V(last obs), solitary semantics
                _, keep = self.net(self._tensor(e.views[-1:]),
                                   self._tensor(e.features[-1:]))
                acc = float(keep[0])
                r = np.asarray(e.rewards, np.float32).copy()
                for i in reversed(range(len(r))):
                    acc = acc * self.gamma + r[i]
                    r[i] = acc
                views.append(np.asarray(e.views, np.float32))
                feats.append(np.asarray(e.features, np.float32))
                acts.append(np.asarray(e.actions, np.int64))
                rets.append(r)

        v = self._tensor(np.concatenate(views))
        f = self._tensor(np.concatenate(feats))
        a = self._tensor(np.concatenate(acts), np.int64)
        ret = self._tensor(np.concatenate(rets))

        policy, value = self.net(v, f)
        advantage = (ret - value).detach()
        log_policy = torch.log(policy + 1e-6)
        log_prob = log_policy.gather(1, a[:, None])[:, 0]
        pg_loss = -(advantage * log_prob).mean()
        vf_loss = self.value_coef * ((ret - value) ** 2).mean()
        neg_entropy = self.ent_coef * (policy * log_policy).sum(dim=1).mean()
        loss = pg_loss + vf_loss + neg_entropy

        self.opt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(self.net.parameters(), 5.0)
        self.opt.step()
        self.train_ct += 1
        losses = [float(t) for t in torch.stack(
            [pg_loss, vf_loss, neg_entropy]).detach().cpu()]
        print("sample", n, *losses)
        return losses, float(value.mean().detach())

    def get_info(self):
        return "torch a2c train_time: %d" % self.train_ct
