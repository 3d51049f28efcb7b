"""The second backend's deep Q network (port of
``magent_tpu/builtin/torch_model/dqn.py``; capability parity with the
reference's MXNet DQN, python/magent/builtin/mx_model/dqn.py).

conv(32, k3) x2 + dense(256) view stream, dense(256) feature stream,
dueling + double Q, a circular host replay with padding masks, the target
net synced every ``target_update`` batches, Adam with global-norm-5
clipping: the JAX package's ``thdqn`` model, run on ``device``.  The
e-greedy draws and the replay rows come from the model's host
``np.random.RandomState(seed)``, as there.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import ReplayBuffer
from .base import TorchBaseModel, build_net


class TorchDQNNet(nn.Module):
    def __init__(self, view_space, feature_space, num_actions,
                 use_dueling=True, use_conv=True):
        super().__init__()
        vh, vw, C = view_space
        self.use_dueling = use_dueling
        self.use_conv = use_conv
        if use_conv and vh >= 5 and vw >= 5:
            self.conv1 = nn.Conv2d(C, 32, 3)
            self.conv2 = nn.Conv2d(32, 32, 3)
            flat = 32 * (vh - 4) * (vw - 4)
        else:
            self.use_conv = False
            flat = vh * vw * C
        self.dense_view = nn.Linear(flat, 256)
        self.dense_emb = nn.Linear(feature_space[0], 256)
        if use_dueling:
            self.value = nn.Linear(512, 1)
            self.advantage = nn.Linear(512, num_actions, bias=False)
        else:
            self.value = nn.Linear(512, num_actions)

    def forward(self, view, feature):
        # view arrives channel-last (the env contract); torch convs want NCHW
        if self.use_conv:
            h = view.permute(0, 3, 1, 2)
            h = F.relu(self.conv1(h))
            h = F.relu(self.conv2(h))
            h = h.flatten(1)
        else:
            h = view.flatten(1)
        h = torch.cat([F.relu(self.dense_view(h)),
                       F.relu(self.dense_emb(feature))], dim=1)
        if self.use_dueling:
            adv = self.advantage(h)
            return self.value(h) + adv - adv.mean(dim=1, keepdim=True)
        return self.value(h)


class DeepQNetwork(TorchBaseModel):
    """Same arguments as the JAX package's ``thdqn`` model, plus
    ``device`` (``None``: the card).  ``num_gpu`` is accepted and unused,
    as there."""

    def __init__(self, env, handle, name,
                 batch_size=64, learning_rate=1e-4, reward_decay=0.99,
                 train_freq=1, target_update=2000, memory_size=2 ** 20,
                 eval_obs=None, use_dueling=True, use_double=True,
                 use_conv=True, custom_view_space=None,
                 custom_feature_space=None, num_gpu=0,
                 infer_batch_size=8192, network_type=0, seed=0, device=None,
                 **kwargs):
        TorchBaseModel.__init__(self, env, handle, name, "thdqn",
                                device=device)

        self.view_space = custom_view_space or env.get_view_space(handle)
        self.feature_space = (custom_feature_space
                              or env.get_feature_space(handle))
        self.num_actions = env.get_action_space(handle)[0]

        self.batch_size = int(batch_size)
        self.train_freq = train_freq
        self.target_update = target_update
        self.eval_obs = eval_obs
        self.infer_batch_size = infer_batch_size
        self.use_double = use_double
        self.gamma = reward_decay
        self.train_ct = 0

        self.net = build_net(TorchDQNNet, self.view_space, self.feature_space,
                             self.num_actions, use_dueling, use_conv,
                             seed=seed, device=self.device)
        self.target_net = copy.deepcopy(self.net)
        self.target_net.eval()
        self.opt = torch.optim.Adam(self.net.parameters(), lr=learning_rate)
        self._rng = np.random.RandomState(seed)

        self.replay_buf_len = 0
        self.memory_size = memory_size
        self.replay_buf_view = ReplayBuffer(
            shape=(memory_size,) + tuple(self.view_space))
        self.replay_buf_feature = ReplayBuffer(
            shape=(memory_size,) + tuple(self.feature_space))
        self.replay_buf_action = ReplayBuffer(shape=(memory_size,),
                                              dtype=np.int32)
        self.replay_buf_reward = ReplayBuffer(shape=(memory_size,))
        self.replay_buf_terminal = ReplayBuffer(shape=(memory_size,),
                                                dtype=bool)
        self.replay_buf_mask = ReplayBuffer(shape=(memory_size,))

    def load_state_arrays(self, flat):
        super().load_state_arrays(flat)
        self.target_net.load_state_dict(self.net.state_dict())

    # ------------------------------------------------------------ inference
    def infer_action(self, raw_obs, ids, policy="e_greedy", eps=0,
                     block=True):
        view, feature = raw_obs[0], raw_obs[1]
        n = len(view)
        if n == 0:
            return np.empty(0, np.int32)
        if policy == "greedy":
            eps = 0.0
        out = np.empty(n, np.int32)
        with torch.no_grad():
            for pos in range(0, n, self.infer_batch_size):
                end = pos + self.infer_batch_size
                q = self.net(self._tensor(view[pos:end]),
                             self._tensor(feature[pos:end]))
                out[pos:pos + len(q)] = q.argmax(dim=1).cpu().numpy()
        if eps > 0:
            explore = self._rng.rand(n) < eps
            out[explore] = self._rng.randint(
                0, self.num_actions, int(explore.sum()))
        return out

    # ------------------------------------------------------------- training
    def _add_to_replay_buffer(self, sample_buffer):
        n = 0
        for episode in sample_buffer.episodes():
            m = len(episode.rewards)
            mask = np.ones(m)
            terminal = np.zeros(m, dtype=bool)
            if episode.terminal:
                terminal[-1] = True
            else:
                mask[-1] = 0
            self.replay_buf_view.put(np.asarray(episode.views))
            self.replay_buf_feature.put(np.asarray(episode.features))
            self.replay_buf_action.put(np.asarray(episode.actions, np.int32))
            self.replay_buf_reward.put(np.asarray(episode.rewards))
            self.replay_buf_terminal.put(terminal)
            self.replay_buf_mask.put(mask)
            n += m
        self.replay_buf_len = min(self.memory_size, self.replay_buf_len + n)
        return n

    def train(self, sample_buffer, print_every=1000, **kwargs):
        add_num = self._add_to_replay_buffer(sample_buffer)
        n_batches = int(self.train_freq * add_num / self.batch_size)
        if n_batches == 0:
            return 0, 0

        print("batch number: %d  add: %d  replay_len: %d/%d" %
              (n_batches, add_num, self.replay_buf_len, self.memory_size))
        start_time = time.time()
        total_loss = 0.0
        mean_target = 0.0
        for ct in range(n_batches):
            idx = self._rng.choice(self.replay_buf_len - 1, self.batch_size)
            v = self._tensor(self.replay_buf_view.get(idx))
            f = self._tensor(self.replay_buf_feature.get(idx))
            a = self._tensor(self.replay_buf_action.get(idx), np.int64)
            nv = self._tensor(self.replay_buf_view.get(idx + 1))
            nf = self._tensor(self.replay_buf_feature.get(idx + 1))
            r = self._tensor(self.replay_buf_reward.get(idx))
            term = self._tensor(self.replay_buf_terminal.get(idx))
            mask = self._tensor(self.replay_buf_mask.get(idx))

            with torch.no_grad():
                tq = self.target_net(nv, nf)
                if self.use_double:
                    sel = self.net(nv, nf).argmax(dim=1, keepdim=True)
                    next_v = tq.gather(1, sel)[:, 0]
                else:
                    next_v = tq.max(dim=1).values
                target = r + (1.0 - term) * self.gamma * next_v
                target = torch.where(term > 0, r, target)

            q = self.net(v, f).gather(1, a[:, None])[:, 0]
            td = (target - q) ** 2
            loss = (td * mask).sum() / mask.sum().clamp(min=1.0)
            self.opt.zero_grad()
            loss.backward()
            torch.nn.utils.clip_grad_norm_(self.net.parameters(), 5.0)
            self.opt.step()

            total_loss += float(loss.detach())
            mean_target = float(target.mean())
            if ct % self.target_update == 0:
                self.target_net.load_state_dict(self.net.state_dict())
            if ct % print_every == 0:
                print("batch %5d,  loss %.6f, eval %.6f"
                      % (ct, float(loss.detach()),
                         self._eval(mean_target)))
            self.train_ct += 1

        total_time = time.time() - start_time
        print("batches: %d,  total time: %.2f" % (n_batches, total_time))
        return total_loss / n_batches, self._eval(mean_target)

    def _eval(self, fallback):
        if self.eval_obs is None:
            return float(fallback)
        with torch.no_grad():
            q = self.net(self._tensor(self.eval_obs[0]),
                         self._tensor(self.eval_obs[1]))
        return float(q.max(dim=1).values.mean())

    def get_info(self):
        return "torch dqn train_time: %d" % self.train_ct
