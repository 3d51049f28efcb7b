"""MAgent's DQN (python/magent/builtin/tf_model/dqn.py) in plain float32
PyTorch operations, on parameter tensors held in a dict.

conv(32, 3x3, valid) x2 and dense(256) over the view, dense(256) over the
features, dueling heads ``value + advantage - mean(advantage)``.  Views
come channel-last ``[N, vh, vw, C]``; the conv output is flattened in
(y, x, c) order.  Parameter names and layouts are PyTorch's
(``conv1.weight`` OIHW, ``dense_view.weight`` ``[out, in]``).

``quant`` rounds each layer's input and weights before the layer (the
lower-precision control); ``None`` computes in float32.  The caller turns
TF32 off (:func:`exact_float32`)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8


def param_shapes(view_space, feature_size, n_action, net):
    vh, vw, C = view_space
    ch, k, d = net["conv_channels"], net["conv_kernel"], net["dense"]
    n_view = (vh - 2 * (k - 1)) * (vw - 2 * (k - 1)) * ch
    return {
        "conv1.weight": (ch, C, k, k), "conv1.bias": (ch,),
        "conv2.weight": (ch, ch, k, k), "conv2.bias": (ch,),
        "dense_view.weight": (d, n_view), "dense_view.bias": (d,),
        "dense_emb.weight": (d, feature_size), "dense_emb.bias": (d,),
        "value.weight": (1, 2 * d), "value.bias": (1,),
        "advantage.weight": (n_action, 2 * d),
    }


def init_params(shapes, generator, device):
    """Weights from ``generator``: one normal draw for all kernels, each
    scaled to variance 1 / fan-in and clipped at two deviations; zero
    biases."""
    kernels = {k: s for k, s in shapes.items() if k.endswith("weight")}
    total = sum(torch.Size(s).numel() for s in kernels.values())
    flat = torch.randn(total, generator=generator, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name not in kernels:
            out[name] = torch.zeros(shape, device=device)
            continue
        n = torch.Size(shape).numel()
        std = torch.Size(shape[1:]).numel() ** -0.5
        out[name] = (flat[at:at + n] * std).clamp(-2 * std, 2 * std).reshape(shape)
        at += n
    return out


def _q(x, quant):
    return x if quant is None else quant(x)


def forward(p, view, feat, quant=None):
    """Q values ``[N, n_action]`` f32."""
    n = view.shape[0]
    h = view.float().permute(0, 3, 1, 2)
    for name in ("conv1", "conv2"):
        h = F.relu(F.conv2d(_q(h, quant), _q(p[name + ".weight"], quant),
                            _q(p[name + ".bias"], quant)))
    h = h.permute(0, 2, 3, 1).reshape(n, -1)
    hv = F.relu(F.linear(_q(h, quant), _q(p["dense_view.weight"], quant),
                         _q(p["dense_view.bias"], quant)))
    he = F.relu(F.linear(_q(feat.float(), quant),
                         _q(p["dense_emb.weight"], quant),
                         _q(p["dense_emb.bias"], quant)))
    dense = torch.cat([hv, he], 1)
    value = F.linear(dense, p["value.weight"], p["value.bias"])
    adv = F.linear(dense, p["advantage.weight"])
    return value + adv - adv.mean(1, keepdim=True)


def td_loss(p, tp, view, feat, act, nview, nfeat, rew, terminal, mask, gamma,
            quant=None):
    """Double-DQN TD(0) loss: mean over ``mask`` of ``(target - Q(s, a))^2``
    where ``target = rew`` if terminal else ``rew + gamma * Qt(s', argmax_a
    Q(s', a))``."""
    q = forward(p, view, feat, quant).gather(1, act[:, None])[:, 0]
    with torch.no_grad():
        sel = forward(p, nview, nfeat, quant).argmax(-1, keepdim=True)
        nv = forward(tp, nview, nfeat, quant).gather(-1, sel)[:, 0]
    target = torch.where(terminal, rew, rew + gamma * nv)
    m = mask.float()
    return ((target - q).square() * m).sum() / m.sum().clamp_min(1.0)


class Adam:
    """``clip_by_global_norm(clip)`` then Adam(lr): optax's arithmetic."""

    def __init__(self, params, lr, clip):
        self.lr, self.clip, self.count = lr, clip, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params, grads):
        norm = torch.stack([g.square().sum() for g in grads.values()]).sum().sqrt()
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        self.count += 1
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] * scale
                self.mu[k] = (1 - B1) * g + B1 * self.mu[k]
                self.nu[k] = (1 - B2) * g.square() + B2 * self.nu[k]
                p.add_(self.mu[k] / bc1 / ((self.nu[k] / bc2).sqrt() + EPS)
                       * -self.lr)


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products and convolutions without TF32."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8(x):
    """Round to float8 e4m3 and back (the control below bfloat16)."""
    return x.to(torch.float8_e4m3fn).to(x.dtype)


def bf16(x):
    """Round to bfloat16 and back (the control below float32)."""
    return x.to(torch.bfloat16).to(x.dtype)
