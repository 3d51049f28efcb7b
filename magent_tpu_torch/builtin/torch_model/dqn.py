"""The deep Q network in PyTorch: the net of the fused trainers and of the
per-agent model (port of the flax ``DQNNet`` and of ``DeepQNetwork``,
``magent_tpu/builtin/jax_model/dqn.py:28-60`` and ``:64-326``).

conv(32, 3x3, valid) x2 + dense(256) view stream, dense(256) feature stream,
dueling value/advantage heads (reference: builtin/tf_model/dqn.py).  The
layer names are the flax module's, so that :func:`params_from_flax` and
:func:`params_to_flax` carry a checkpoint (``tfdqn_<n>.npz``, written by
``jax_model/base.py``'s ``_flatten_pytree``) across unchanged.

Layouts: the input view is channel-last ``[N, vh, vw, C]`` as the env
renders it; the convs run on its NCHW view (channels-last strides, no
copy), and the conv output is flattened in (y, x, c) order, as flax's NHWC
``reshape`` flattens it, so ``dense_view``'s weight is the flax kernel
transposed with no column permutation.  Conv kernels are HWIO in flax and
OIHW here; dense kernels ``[in, out]`` there, ``[out, in]`` here
(:mod:`.flax_params`).

The JAX package's CPU ``TorchDQNNet`` (``magent_tpu/builtin/torch_model``)
has a parameter layout of its own and is not this class.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.optim import ClipAdam
from ...parallel.sharding import linear
from ..common import ReplayBuffer
from ...parallel.vec_env import resolve_device
from .base import CheckpointModel, compute_dtype, round_up_pow2
from .flax_params import (init_dense_, params_from_flax, params_to_flax,
                          tensors_to_flax)

__all__ = ["DQNNet", "DeepQNetwork", "params_from_flax", "params_to_flax",
           "tensors_to_flax"]

DTYPES = (torch.float32, torch.bfloat16)


class DQNNet(nn.Module):
    """``DQNNet(view_space, feature_size, num_actions)``: Q values ``[N,
    num_actions]`` f32 of views ``[N, vh, vw, C]`` and features ``[N, F]``.

    ``dtype`` is the compute dtype of the convs and the two 256-wide dense
    layers (the flax module's ``dtype``): the parameters stay f32 and are
    cast inside the forward pass, so autograd carries the gradients back to
    the f32 parameters; the heads and the Q arithmetic run in f32.  Flax
    infers input widths at ``init``; here ``view_space`` ``(vh, vw, C)`` and
    ``feature_size`` give them."""

    def __init__(self, view_space, feature_size: int, num_actions: int,
                 use_dueling: bool = True, use_conv: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError("DQNNet: dtype must be torch.float32 or "
                             "torch.bfloat16, got %s" % dtype)
        vh, vw, C = view_space
        self.num_actions = num_actions
        self.use_dueling = use_dueling
        self.use_conv = use_conv
        self.dtype = dtype
        if use_conv:
            self.conv1 = nn.Conv2d(C, 32, 3)
            self.conv2 = nn.Conv2d(32, 32, 3)
            n_view = (vh - 4) * (vw - 4) * 32
        else:
            n_view = vh * vw * C
        self.dense_view = nn.Linear(n_view, 256)
        self.dense_emb = nn.Linear(feature_size, 256)
        if use_dueling:
            self.value = nn.Linear(512, 1)
            self.advantage = nn.Linear(512, num_actions, bias=False)
        else:
            self.value = nn.Linear(512, num_actions)

    def _trunk(self, layer, x, op):
        return F.relu(linear(layer, x, self.dtype, op))

    def forward(self, view, feature):
        dt = self.dtype
        n = view.shape[0]
        h = view.to(dt)
        if self.use_conv:
            h = h.permute(0, 3, 1, 2)  # NCHW shape, channels-last strides
            h = self._trunk(self.conv1, h, F.conv2d)
            h = self._trunk(self.conv2, h, F.conv2d)
            h = h.permute(0, 2, 3, 1)  # (y, x, c) order, as flax flattens
        h_view = self._trunk(self.dense_view, h.reshape(n, -1), F.linear)
        h_emb = self._trunk(self.dense_emb, feature.to(dt), F.linear)
        dense = torch.cat([h_view, h_emb], 1).float()
        if not self.use_dueling:
            return self.value(dense)
        value = self.value(dense)
        advantage = self.advantage(dense)
        return value + advantage - advantage.mean(1, keepdim=True)


class DeepQNetwork(CheckpointModel):
    """The per-agent parameter-sharing DQN (JAX ``jax_model/dqn.py:64-326``;
    reference: python/magent/builtin/tf_model/dqn.py): e-greedy inference
    in chunks of ``infer_batch_size``, a host NumPy replay of
    ``memory_size`` transitions with terminal and padding masks, double and
    dueling Q, the target net copied every ``target_update`` batches (and
    at the first batch of each ``train`` call, as the JAX model does),
    ``clip_by_global_norm(5)`` then Adam (:class:`ClipAdam`).

    Same arguments as the JAX class, plus ``device`` (``None``: the card)
    and ``devices``, the local devices :meth:`shard_inference` may use
    (default: every visible card for a model on a card, the model's one
    device on the CPU; a list of CPU devices is the CPU's counterpart of
    the JAX tests' virtual host devices).  ``num_gpu > 1`` shards the
    inference over that many of them.  Fresh nets are flax's initializers
    drawn from a torch generator seeded ``seed``, not flax's draws; load a
    checkpoint to share weights with the JAX model.

    Host syncs: an ``infer_action`` chunk copies its views and features to
    the device and its actions back; a train batch copies its eight
    minibatch arrays to the device, and the losses stay there until the
    call ends, as in the JAX model."""

    def __init__(self, env, handle, name,
                 batch_size=64, learning_rate=1e-4, reward_decay=0.99,
                 train_freq=1, target_update=2000, memory_size=2 ** 20,
                 eval_obs=None, use_dueling=True, use_double=True,
                 use_conv=True, custom_view_space=None,
                 custom_feature_space=None, num_gpu=1, infer_batch_size=8192,
                 network_type=0, seed=0, dtype="f32", device=None,
                 devices=None):
        CheckpointModel.__init__(self, env, handle, name, "tfdqn",
                                 device=device, seed=seed)

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

        self.net = DQNNet(self.view_space, self.feature_space[0],
                          self.num_actions, use_dueling, use_conv,
                          dtype=compute_dtype(dtype))
        init_dense_(self.net, torch.Generator().manual_seed(seed))
        self.net.to(self.device)
        self.tx = ClipAdam(learning_rate, 5.0)
        self._restart_training()

        # data-parallel inference: one eval-net replica per local device,
        # the reference DQN's per-GPU round-robin
        # (reference: tf_model/dqn.py:368-393), through the same knob
        self._devices = devices
        self._replicas = None
        self._infer_devices = 1
        if num_gpu and num_gpu > 1:
            self.shard_inference(num_gpu)

        # ---- replay buffers (reference: dqn.py:140-149) ----
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

    def _restart_training(self):
        self.target_net = copy.deepcopy(self.net).requires_grad_(False)
        self.opt_state = self.tx.init(self.net)

    def local_devices(self):
        """The devices :meth:`shard_inference` may use, in order."""
        if self._devices is not None:
            return [resolve_device(d) for d in self._devices]
        if self.device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [self.device]

    def shard_inference(self, n_devices=None):
        """Split large ``infer_action`` chunks data-parallel over the first
        ``n_devices`` local devices (capped at their number; all of them
        when None; ``n <= 1`` goes back to the single-device path), one
        replica of the eval net on each (JAX ``dqn.py:154-161``): a chunk's
        padded size is rounded up to a multiple of the device count, as
        JAX's sharded program pads it, its rows split evenly, each part's Q
        values computed on its device and the parts concatenated.  The
        e-greedy draw is the single path's, at the padded shape."""
        devs = self.local_devices()
        n = min(n_devices or len(devs), len(devs))
        if n <= 1:
            self._replicas = None
            self._infer_devices = 1
            return self
        self._replicas = [copy.deepcopy(self.net).to(d).requires_grad_(False)
                          for d in devs[:n]]
        self._infer_devices = n
        return self

    def _sharded_q(self, view, feature, padded):
        """Q values ``[n, n_act]`` on the model's device of host rows split
        in parts of ``padded / d`` rows over the ``d`` replicas (the padding
        rows' Q values are never read, so they are not computed)."""
        m = padded // self._infer_devices
        state = self.net.state_dict()
        parts = []
        with torch.no_grad():
            for i, rep in enumerate(self._replicas):
                lo, hi = i * m, min((i + 1) * m, len(view))
                if lo >= hi:
                    break
                rep.load_state_dict(state)  # the current online weights
                dev = next(rep.parameters()).device
                v, f = (torch.from_numpy(np.ascontiguousarray(
                    a[lo:hi], np.float32)).to(dev) for a in (view, feature))
                parts.append(rep(v, f).to(self.device))
        return torch.cat(parts)

    # ------------------------------------------------------------ inference
    def _q(self, view, feature):
        """Q values ``[n, n_act]`` f32 on the device of host views and
        features (no gradient)."""
        with torch.no_grad():
            return self.net(self._tensor(view), self._tensor(feature))

    def infer_action(self, raw_obs, ids, policy="e_greedy", eps=0,
                     block=True):
        view, feature = raw_obs[0], raw_obs[1]
        n = len(view)
        if n == 0:
            return np.empty(0, np.int32)
        if policy == "greedy":
            eps = 0.0

        out = np.empty(n, np.int32)
        pos = 0
        while pos < n:
            chunk = min(n - pos, self.infer_batch_size)
            padded = round_up_pow2(chunk)
            rows = (view[pos : pos + chunk], feature[pos : pos + chunk])
            if self._replicas is None:
                q = self._q(*rows)
            else:
                d = self._infer_devices  # the batch splits evenly over dp
                padded = -(-padded // d) * d
                q = self._sharded_q(*rows, padded)
            acts = self._egreedy(q, padded, eps)
            out[pos : pos + chunk] = acts.cpu().numpy()
            pos += chunk
        return out

    # ------------------------------------------------------------- training
    def _add_to_replay_buffer(self, sample_buffer):
        """episodes -> flat circular buffers with terminal/padding masks
        (reference: dqn.py:250-275)"""
        n = 0
        for episode in sample_buffer.episodes():
            v, f, a, r = (episode.views, episode.features, episode.actions,
                          episode.rewards)
            m = len(r)
            mask = np.ones(m)
            terminal = np.zeros(m, dtype=bool)
            if episode.terminal:
                terminal[-1] = True
            else:
                mask[-1] = 0

            self.replay_buf_view.put(np.asarray(v))
            self.replay_buf_feature.put(np.asarray(f))
            self.replay_buf_action.put(np.asarray(a, np.int32))
            self.replay_buf_reward.put(np.asarray(r))
            self.replay_buf_terminal.put(terminal)
            self.replay_buf_mask.put(mask)
            n += m

        self.replay_buf_len = min(self.memory_size, self.replay_buf_len + n)
        return n

    def _train_step(self, index):
        """One gradient step on the replay rows ``index`` -> (loss, mean
        target), 0-d tensors left on the device (JAX ``train_step``)."""
        view, next_view = (self._tensor(self.replay_buf_view.get(i))
                           for i in (index, index + 1))
        feat, next_feat = (self._tensor(self.replay_buf_feature.get(i))
                           for i in (index, index + 1))
        action = self._tensor(self.replay_buf_action.get(index), np.int64)
        reward = self._tensor(self.replay_buf_reward.get(index))
        terminal = self._tensor(self.replay_buf_terminal.get(index), bool)
        mask = self._tensor(self.replay_buf_mask.get(index))
        with torch.no_grad():
            t_q = self.target_net(next_view, next_feat)
            if self.use_double:
                sel = self.net(next_view, next_feat).argmax(1, keepdim=True)
                next_value = t_q.gather(1, sel)[:, 0]
            else:
                next_value = t_q.max(1).values
            target = torch.where(terminal, reward,
                                 reward + self.gamma * next_value)
        q_a = self.net(view, feat).gather(1, action[:, None])[:, 0]
        loss = ((target - q_a).square() * mask).sum() / \
            mask.sum().clamp_min(1.0)
        self.net.zero_grad(set_to_none=True)
        loss.backward()
        self.opt_state = self.tx.update(self.net, self.opt_state)
        return loss.detach(), target.mean()

    def train(self, sample_buffer, print_every=1000, **kwargs):
        add_num = self._add_to_replay_buffer(sample_buffer)
        batch_size = self.batch_size

        n_batches = int(self.train_freq * add_num / batch_size)
        if n_batches == 0:
            return 0, 0

        print("batch number: %d  add: %d  replay_len: %d/%d" %
              (n_batches, add_num, self.replay_buf_len, self.memory_size))

        start_time = time.time()
        ct = 0
        mean_target = 0.0
        losses = []
        for _ in range(n_batches):
            index = np.random.choice(self.replay_buf_len - 1, batch_size)
            loss, mean_target = self._train_step(index)
            losses.append(loss)  # read once, after the loop

            if ct % self.target_update == 0:
                self.target_net.load_state_dict(self.net.state_dict())
            if ct % print_every == 0:
                print("batch %5d,  loss %.6f, eval %.6f" % (
                    ct, float(loss), self._eval(mean_target)))
            ct += 1
            self.train_ct += 1

        total_loss = float(torch.stack(losses).sum())
        total_time = time.time() - start_time
        print("batches: %d,  total time: %.2f,  1k average: %.2f" %
              (ct, total_time, total_time / max(1.0, ct / 1000.0)))

        return total_loss / ct, self._eval(mean_target)

    def _eval(self, fallback):
        """mean max-Q on the held-out eval set (reference: dqn.py:348-366)"""
        if self.eval_obs is None:
            return float(fallback)
        q = self._q(self.eval_obs[0], self.eval_obs[1])
        return float(q.max(1).values.mean())

    def get_info(self):
        return "torch dqn train_time: %d" % self.train_ct
