"""DDPG, DQN, LRPG and NAF networks and the pixel encoders
(cartpoleplusplus_tpu/models/nets.py ActorMLP, CriticMLP, QNetMLP,
PolicyMLP, NafNet, PixelEncoder, PatchEncoder and the Visual* nets in
torch), with flax's numerics rather than torch's defaults:

  * LayerNorm uses eps 1e-6 and the one-pass variance max(E[x^2] - E[x]^2,
    0), and applies (x - mean) * (rsqrt(var + eps) * scale) + bias;
  * Dense kernels initialise lecun-normal (truncated, flax's stddev
    correction), biases zero, and the DDPG output heads U[0, 3e-3);
  * the critic joins the action after its first layer;
  * a Conv pads 'SAME' as flax does (at stride 2 on an even size: 0 before
    and 1 after on each spatial axis), takes and flattens images in (H, W,
    C) order, and scales uint8 input by float32(1/255).

Weights are stored torch-style (Linear.weight is (out, in));
models/from_jax.py converts flax parameter trees into these modules.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax.linen.LayerNorm default epsilon
# flax's truncated lecun_normal divides the stddev by the std of a unit
# normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978
HEAD_INIT = 3e-3


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis (fast variance)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        mean2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.weight
        return (x - mean) * mul + self.bias


def polyak(target: nn.Module, online: nn.Module, tau: float) -> None:
    """theta' <- (1 - tau) * theta' + tau * theta, in place."""
    with torch.no_grad():
        for t, o in zip(target.parameters(), online.parameters()):
            t.copy_((1.0 - tau) * t + tau * o)


def _lecun_normal_(w: torch.Tensor, generator) -> None:
    std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


def _init_dense(layer: nn.Linear, generator, head: bool = False) -> None:
    with torch.no_grad():
        if head:
            nn.init.uniform_(layer.weight, 0.0, HEAD_INIT,
                             generator=generator)
        else:
            _lecun_normal_(layer.weight, generator)
        layer.bias.zero_()


class _TorsoMLP(nn.Module):
    """[Dense -> LayerNorm -> relu] x len(hidden), then a Dense head of
    `out` units (flax's `_Torso` + head)."""

    def __init__(self, obs_dim: int, out: int, hidden: Sequence[int],
                 generator, uniform_head: bool):
        super().__init__()
        self.hidden = tuple(hidden)
        dims = (obs_dim,) + self.hidden
        self.torso = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(LayerNorm(h) for h in self.hidden)
        self.head = nn.Linear(dims[-1], out)
        for layer in self.torso:
            _init_dense(layer, generator)
        _init_dense(self.head, generator, head=uniform_head)

    def features(self, obs):
        x = obs
        for dense, norm in zip(self.torso, self.norms):
            x = torch.relu(norm(dense(x)))
        return x


class ActorMLP(_TorsoMLP):
    """Deterministic policy mu(s) in [-1, 1]^action_dim (DDPG actor): the
    torso, then a tanh head initialised U[0, 3e-3)."""

    def __init__(self, obs_dim: int, action_dim: int = 2,
                 hidden: Sequence[int] = (256, 256), generator=None):
        super().__init__(obs_dim, action_dim, hidden, generator,
                         uniform_head=True)

    def forward(self, obs):
        return torch.tanh(self.head(self.features(obs)))


class QNetMLP(_TorsoMLP):
    """Q(s, .) over the discrete actions (DQN): the actor's torso and a
    linear head with flax's default Dense init (truncated lecun-normal
    kernel, zero bias)."""

    def __init__(self, obs_dim: int, num_actions: int = 5,
                 hidden: Sequence[int] = (256, 256), generator=None):
        super().__init__(obs_dim, num_actions, hidden, generator,
                         uniform_head=False)

    def forward(self, obs):
        return self.head(self.features(obs))


class PolicyMLP(QNetMLP):
    """Softmax policy logits over the discrete actions (LRPG): QNetMLP's
    structure and init, hidden (64, 64) by default."""

    def __init__(self, obs_dim: int, num_actions: int = 5,
                 hidden: Sequence[int] = (64, 64), generator=None):
        super().__init__(obs_dim, num_actions, hidden, generator)


def softplus(x):
    """jax.nn.softplus's stable form: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


class NafNet(_TorsoMLP):
    """Normalized Advantage Function (NAF): Q(s, a) = V(s) + A(s, a) with
    A = -1/2 (a - mu)^T L L^T (a - mu), L lower-triangular with a softplus
    diagonal. The flax net's three Dense heads (V, mu, the L entries) are
    one packed head of rows [v, mu_0..mu_{d-1}, l_0..] (the reference
    kernel's packing, ops/learner_kernel.py::flatten_naf, without its pad
    rows): rows v and l take flax's default Dense init, the mu rows U[0,
    3e-3), every row with fan-in H."""

    def __init__(self, obs_dim: int, action_dim: int = 2,
                 hidden: Sequence[int] = (256, 256), generator=None):
        self.action_dim = action_dim
        super().__init__(obs_dim, 1 + action_dim
                         + action_dim * (action_dim + 1) // 2, hidden,
                         generator, uniform_head=False)
        with torch.no_grad():
            mu_rows = self.head.weight[1:1 + action_dim]
            mu_rows.copy_(torch.empty_like(mu_rows).uniform_(
                0.0, HEAD_INIT, generator=generator))

    def forward(self, obs, action=None):
        """(v, mu), or (q, mu, v) when an action is given."""
        d = self.action_dim
        out = self.head(self.features(obs))
        v = out[..., 0]
        mu = torch.tanh(out[..., 1:1 + d])
        if action is None:
            return v, mu
        rows, cols = torch.tril_indices(d, d, device=out.device)
        l_mat = torch.zeros(out.shape[:-1] + (d * d,), dtype=out.dtype,
                            device=out.device).index_copy(
            -1, rows * d + cols, out[..., 1 + d:]).unflatten(-1, (d, d))
        eye = torch.eye(d, dtype=torch.bool, device=out.device)
        l_mat = torch.where(eye, softplus(l_mat), l_mat)
        p_mat = l_mat @ l_mat.transpose(-1, -2)
        da = (action - mu)[..., None]
        adv = -0.5 * (da.transpose(-1, -2) @ p_mat @ da)[..., 0, 0]
        return v + adv, mu, v


class CriticMLP(nn.Module):
    """Q(s, a): the action joins after the first layer (DDPG critic)."""

    def __init__(self, obs_dim: int, action_dim: int = 2,
                 hidden: Sequence[int] = (256, 256), generator=None):
        super().__init__()
        self.hidden = tuple(hidden)
        ins = (obs_dim, self.hidden[0] + action_dim) + self.hidden[1:-1]
        self.torso = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(ins, self.hidden))
        self.norms = nn.ModuleList(LayerNorm(h) for h in self.hidden)
        head_in = self.hidden[-1] + (action_dim if len(hidden) == 1 else 0)
        self.head = nn.Linear(head_in, 1)
        for layer in self.torso:
            _init_dense(layer, generator)
        _init_dense(self.head, generator, head=True)

    def forward(self, obs, action):
        x = obs
        for i, (dense, norm) in enumerate(zip(self.torso, self.norms)):
            x = torch.relu(norm(dense(x)))
            if i == 0:
                x = torch.cat([x, action], dim=-1)
        return self.head(x).squeeze(-1)


_INV_255 = float(np.float32(1.0 / 255.0))


def _as_float_image(img):
    """uint8 frames (the env's quantized obs) -> float32 * float32(1/255);
    float frames -> float32."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * _INV_255
    return img.to(torch.float32)


def _same_pad(size: int, stride: int, kernel: int) -> tuple:
    """flax/XLA 'SAME' padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class PixelEncoder(nn.Module):
    """Small conv stack for pixel observations -> flat features: per
    width in `features` a 3x3 stride-2 'SAME' conv and relu, then the
    (H', W', C') map flattened. Input (..., H, W, C) float in [0, 1] or
    uint8. The convolutions may run in cuDNN (the reference leaves them to
    XLA, outside any kernel of its own)."""

    def __init__(self, obs_shape, features: Sequence[int] = (16, 32, 32),
                 generator=None):
        super().__init__()
        h, w, c = obs_shape
        self.convs = nn.ModuleList()
        self.pads = []
        for f in features:
            conv = nn.Conv2d(c, f, kernel_size=3, stride=2)
            with torch.no_grad():
                std = math.sqrt(1.0 / (c * 9)) / _TRUNC_STD
                nn.init.trunc_normal_(conv.weight, std=std, a=-2.0 * std,
                                      b=2.0 * std, generator=generator)
                conv.bias.zero_()
            self.convs.append(conv)
            ph, pw = _same_pad(h, 2, 3), _same_pad(w, 2, 3)
            self.pads.append((pw[0], pw[1], ph[0], ph[1]))
            h, w, c = -(-h // 2), -(-w // 2), f
        self.out_dim = h * w * c

    def forward(self, img):
        lead = img.shape[:-3]
        x = _as_float_image(img).reshape((-1,) + img.shape[-3:])
        x = x.permute(0, 3, 1, 2)                      # NHWC -> NCHW
        for conv, pad in zip(self.convs, self.pads):
            x = torch.relu(conv(F.pad(x, pad)))
        x = x.permute(0, 2, 3, 1)                      # flax's (H, W, C)
        return x.reshape(lead + (self.out_dim,))


class PatchEncoder(nn.Module):
    """Non-overlapping patch embedding: each P x P patch (P*P*C values in
    (row, col, channel) order) through [Dense -> LayerNorm -> relu] per
    width in `features`, then the (H/P) (W/P) patch features flattened."""

    def __init__(self, obs_shape, patch: int = 6,
                 features: Sequence[int] = (128, 32), generator=None):
        super().__init__()
        h, w, c = obs_shape
        self.patch = patch
        self.hp, self.wp = h // patch, w // patch
        dims = (patch * patch * c,) + tuple(features)
        self.dense = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(LayerNorm(f) for f in features)
        for layer in self.dense:
            _init_dense(layer, generator)
        self.out_dim = self.hp * self.wp * features[-1]

    def forward(self, img):
        lead = img.shape[:-3]
        *_, h, w, c = img.shape
        p, hp, wp = self.patch, self.hp, self.wp
        x = _as_float_image(img).reshape(lead + (hp, p, wp, p, c))
        x = x.movedim(-4, -3)                          # (..., hp, wp, p, p, c)
        x = x.reshape(lead + (hp * wp, p * p * c))
        for dense, norm in zip(self.dense, self.norms):
            x = torch.relu(norm(dense(x)))
        return x.reshape(lead + (self.out_dim,))


def make_encoder(encoder: str, obs_shape, conv_features, generator=None):
    """The Visual* nets' encoder: "conv" (PixelEncoder over
    `conv_features`) or "patch" (PatchEncoder at its defaults)."""
    if encoder == "patch":
        return PatchEncoder(obs_shape, generator=generator)
    if encoder != "conv":
        raise ValueError(f"encoder must be 'conv' or 'patch', got "
                         f"{encoder!r}")
    return PixelEncoder(obs_shape, conv_features, generator=generator)


class _VisualNet(nn.Module):
    """An encoder (`make_encoder`: "conv" or "patch") in front of the MLP
    `mlp_cls`, which takes the encoder's flat features and any further
    arguments (an action) as it takes a flat observation."""

    mlp_cls = None

    def __init__(self, obs_shape, n_out: int, hidden: Sequence[int],
                 features: Sequence[int] = (16, 32, 32),
                 encoder: str = "conv", generator=None):
        super().__init__()
        self.encoder = make_encoder(encoder, obs_shape, features, generator)
        self.mlp = self.mlp_cls(self.encoder.out_dim, n_out, hidden,
                                generator=generator)
        self.hidden = self.mlp.hidden

    def forward(self, img, *args):
        return self.mlp(self.encoder(img), *args)


class VisualActor(_VisualNet):
    """Encoder + ActorMLP: the deterministic policy from frames;
    (obs_shape, action_dim, hidden, ...)."""

    mlp_cls = ActorMLP


class VisualCritic(_VisualNet):
    """Encoder + CriticMLP: Q(frames, action); (obs_shape, action_dim,
    hidden, ...)."""

    mlp_cls = CriticMLP


class VisualQNet(_VisualNet):
    """Encoder + QNetMLP: discrete Q-values from frames (pixel DQN);
    (obs_shape, num_actions, hidden, ...)."""

    mlp_cls = QNetMLP


class VisualNafNet(_VisualNet):
    """Encoder + NafNet: the quadratic-advantage Q from frames (pixel NAF),
    with NafNet's contract: (v, mu) without an action, (q, mu, v) with
    one; (obs_shape, action_dim, hidden, ...)."""

    mlp_cls = NafNet


class VisualPolicy(_VisualNet):
    """Encoder + PolicyMLP: softmax policy logits from frames (pixel LRPG);
    (obs_shape, num_actions, hidden, ...)."""

    mlp_cls = PolicyMLP
