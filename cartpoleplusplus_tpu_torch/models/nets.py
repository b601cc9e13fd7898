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
    C) order, and scales uint8 input by float32(1/255);
  * every net takes `dtype`, its compute dtype (flax's `dtype`): float32,
    or bfloat16 with the parameters still float32 (flax's `param_dtype`)
    and flax's rounding order under jit (what the reference trains
    with): each Dense and Conv casts input, weight and bias to bfloat16
    and rounds the product to bfloat16 before the bias joins it (never
    one fused addmm); a Dense's sum reaches its LayerNorm or float32 head
    unrounded (XLA's excess precision), a Conv's is rounded to bfloat16;
    LayerNorm takes its statistics, scale and bias in float32 and casts
    once; a tanh head takes tanh in float32 of its rounded sum.

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


def compute_dtype(name: str) -> torch.dtype:
    """An agent config's `dtype` string -> the nets' compute dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def dense(layer: nn.Linear, x, dtype=torch.float32):
    """flax.linen.Dense at compute dtype `dtype`, as the jit-compiled apply
    computes it. float32 is the Linear itself; bfloat16 casts input,
    kernel and bias (flax's promote_dtype), rounds the product to
    bfloat16, and adds the bias in float32, returning the float32 sum:
    every Dense of the nets feeds a LayerNorm or a float32 head, and under
    jit XLA drops the sum's rounding to bfloat16 there (its excess
    precision), so the sum reaches them unrounded."""
    if dtype == torch.float32:
        return layer(x)
    return (F.linear(x.to(dtype), layer.weight.to(dtype)).to(torch.float32)
            + layer.bias.to(dtype).to(torch.float32))


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis (fast variance). At a
    bfloat16 `dtype` the statistics, rsqrt, scale and bias are float32 on
    the bfloat16 input (flax's _compute_stats promotes), and the result
    is cast to bfloat16 once."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if self.dtype != torch.float32:
            return self._normalize(x.to(torch.float32)).to(self.dtype)
        return self._normalize(x)

    def _normalize(self, x):
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


def _tanh_head(a, dtype):
    """flax's tanh(Dense(x)).astype(float32) as the jit-compiled apply
    computes it: the head's sum rounded to the compute dtype, then tanh in
    float32 (XLA keeps tanh's float32 result, not rounding it first)."""
    return torch.tanh(a.to(dtype).to(torch.float32))


class _TorsoMLP(nn.Module):
    """[Dense -> LayerNorm -> relu] x len(hidden), then a Dense head of
    `out` units (flax's `_Torso` + head), computed at `dtype`."""

    def __init__(self, obs_dim: int, out: int, hidden: Sequence[int],
                 generator, uniform_head: bool, dtype=torch.float32):
        super().__init__()
        self.hidden = tuple(hidden)
        self.dtype = dtype
        dims = (obs_dim,) + self.hidden
        self.torso = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(LayerNorm(h, dtype) for h in self.hidden)
        self.head = nn.Linear(dims[-1], out)
        for layer in self.torso:
            _init_dense(layer, generator)
        _init_dense(self.head, generator, head=uniform_head)

    def features(self, obs):
        x = obs.to(self.dtype)
        for layer, norm in zip(self.torso, self.norms):
            x = torch.relu(norm(dense(layer, x, self.dtype)))
        return x

    def head_out(self, obs):
        """The head's output at the compute dtype."""
        return dense(self.head, self.features(obs), self.dtype)


class ActorMLP(_TorsoMLP):
    """Deterministic policy mu(s) in [-1, 1]^action_dim (DDPG actor): the
    torso, then a tanh head initialised U[0, 3e-3)."""

    def __init__(self, obs_dim: int, action_dim: int = 2,
                 hidden: Sequence[int] = (256, 256), generator=None,
                 dtype=torch.float32):
        super().__init__(obs_dim, action_dim, hidden, generator,
                         uniform_head=True, dtype=dtype)

    def forward(self, obs):
        return _tanh_head(self.head_out(obs), self.dtype)


class QNetMLP(_TorsoMLP):
    """Q(s, .) over the discrete actions (DQN): the actor's torso and a
    linear head with flax's default Dense init (truncated lecun-normal
    kernel, zero bias)."""

    def __init__(self, obs_dim: int, num_actions: int = 5,
                 hidden: Sequence[int] = (256, 256), generator=None,
                 dtype=torch.float32):
        super().__init__(obs_dim, num_actions, hidden, generator,
                         uniform_head=False, dtype=dtype)

    def forward(self, obs):
        return self.head_out(obs).to(torch.float32)


class PolicyMLP(QNetMLP):
    """Softmax policy logits over the discrete actions (LRPG): QNetMLP's
    structure and init, hidden (64, 64) by default."""

    def __init__(self, obs_dim: int, num_actions: int = 5,
                 hidden: Sequence[int] = (64, 64), generator=None,
                 dtype=torch.float32):
        super().__init__(obs_dim, num_actions, hidden, generator, dtype)


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
                 hidden: Sequence[int] = (256, 256), generator=None,
                 dtype=torch.float32):
        self.action_dim = action_dim
        super().__init__(obs_dim, 1 + action_dim
                         + action_dim * (action_dim + 1) // 2, hidden,
                         generator, uniform_head=False, dtype=dtype)
        with torch.no_grad():
            mu_rows = self.head.weight[1:1 + action_dim]
            mu_rows.copy_(torch.empty_like(mu_rows).uniform_(
                0.0, HEAD_INIT, generator=generator))

    def forward(self, obs, action=None):
        """(v, mu), or (q, mu, v) when an action is given."""
        d = self.action_dim
        out = self.head_out(obs).to(torch.float32)
        v = out[..., 0].to(self.dtype).to(torch.float32)
        mu = _tanh_head(out[..., 1:1 + d], self.dtype)
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
                 hidden: Sequence[int] = (256, 256), generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.hidden = tuple(hidden)
        self.dtype = dtype
        ins = (obs_dim, self.hidden[0] + action_dim) + self.hidden[1:-1]
        self.torso = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(ins, self.hidden))
        self.norms = nn.ModuleList(LayerNorm(h, dtype) for h in self.hidden)
        head_in = self.hidden[-1] + (action_dim if len(hidden) == 1 else 0)
        self.head = nn.Linear(head_in, 1)
        for layer in self.torso:
            _init_dense(layer, generator)
        _init_dense(self.head, generator, head=True)

    def forward(self, obs, action):
        x = obs.to(self.dtype)
        for i, (layer, norm) in enumerate(zip(self.torso, self.norms)):
            x = torch.relu(norm(dense(layer, x, self.dtype)))
            if i == 0:
                x = torch.cat([x, action.to(self.dtype)], dim=-1)
        return dense(self.head, x, self.dtype).to(self.dtype).squeeze(-1).to(torch.float32)


_INV_255 = float(np.float32(1.0 / 255.0))


def _as_float_image(img, dtype=torch.float32):
    """uint8 frames (the env's quantized obs) -> `dtype` * `dtype`(1/255),
    rounded to `dtype`; float frames -> `dtype`."""
    if img.dtype != torch.uint8:
        return img.to(dtype)
    if dtype == torch.float32:
        return img.to(torch.float32) * _INV_255
    # A tensor of `dtype`, not a Python scalar: torch would take a scalar
    # at float32 where flax multiplies by dtype(1/255).
    return img.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype,
                                        device=img.device)


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
                 generator=None, dtype=torch.float32):
        super().__init__()
        h, w, c = obs_shape
        self.dtype = dtype
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
        dt = self.dtype
        x = _as_float_image(img, dt).reshape((-1,) + img.shape[-3:])
        x = x.permute(0, 3, 1, 2)                      # NHWC -> NCHW
        for conv, pad in zip(self.convs, self.pads):
            x = F.pad(x, pad)
            if dt == torch.float32:
                x = conv(x)
            else:  # product, then bias, as `dense`
                x = (F.conv2d(x, conv.weight.to(dt), None, conv.stride)
                     + conv.bias.to(dt)[:, None, None])
            x = torch.relu(x)
        x = x.permute(0, 2, 3, 1)                      # flax's (H, W, C)
        return x.reshape(lead + (self.out_dim,)).to(torch.float32)


class PatchEncoder(nn.Module):
    """Non-overlapping patch embedding: each P x P patch (P*P*C values in
    (row, col, channel) order) through [Dense -> LayerNorm -> relu] per
    width in `features`, then the (H/P) (W/P) patch features flattened."""

    def __init__(self, obs_shape, patch: int = 6,
                 features: Sequence[int] = (128, 32), generator=None,
                 dtype=torch.float32):
        super().__init__()
        h, w, c = obs_shape
        self.dtype = dtype
        self.patch = patch
        self.hp, self.wp = h // patch, w // patch
        dims = (patch * patch * c,) + tuple(features)
        self.dense = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(LayerNorm(f, dtype) for f in features)
        for layer in self.dense:
            _init_dense(layer, generator)
        self.out_dim = self.hp * self.wp * features[-1]

    def forward(self, img):
        lead = img.shape[:-3]
        *_, h, w, c = img.shape
        p, hp, wp = self.patch, self.hp, self.wp
        x = _as_float_image(img, self.dtype).reshape(lead
                                                     + (hp, p, wp, p, c))
        x = x.movedim(-4, -3)                          # (..., hp, wp, p, p, c)
        x = x.reshape(lead + (hp * wp, p * p * c))
        for layer, norm in zip(self.dense, self.norms):
            x = torch.relu(norm(dense(layer, x, self.dtype)))
        return x.reshape(lead + (self.out_dim,)).to(torch.float32)


def make_encoder(encoder: str, obs_shape, conv_features, generator=None,
                 dtype=torch.float32):
    """The Visual* nets' encoder: "conv" (PixelEncoder over
    `conv_features`) or "patch" (PatchEncoder at its defaults)."""
    if encoder == "patch":
        return PatchEncoder(obs_shape, generator=generator, dtype=dtype)
    if encoder != "conv":
        raise ValueError(f"encoder must be 'conv' or 'patch', got "
                         f"{encoder!r}")
    return PixelEncoder(obs_shape, conv_features, generator=generator,
                        dtype=dtype)


class _VisualNet(nn.Module):
    """An encoder (`make_encoder`: "conv" or "patch") in front of the MLP
    `mlp_cls`, which takes the encoder's flat features and any further
    arguments (an action) as it takes a flat observation."""

    mlp_cls = None

    def __init__(self, obs_shape, n_out: int, hidden: Sequence[int],
                 features: Sequence[int] = (16, 32, 32),
                 encoder: str = "conv", generator=None, dtype=torch.float32):
        super().__init__()
        self.encoder = make_encoder(encoder, obs_shape, features, generator,
                                    dtype)
        self.mlp = self.mlp_cls(self.encoder.out_dim, n_out, hidden,
                                generator=generator, dtype=dtype)
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
