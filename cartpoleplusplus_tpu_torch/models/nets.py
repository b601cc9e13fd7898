"""DDPG networks (cartpoleplusplus_tpu/models/nets.py ActorMLP / CriticMLP
in torch), with flax's numerics rather than torch's defaults:

  * LayerNorm uses eps 1e-6 and the one-pass variance max(E[x^2] - E[x]^2,
    0), and applies (x - mean) * (rsqrt(var + eps) * scale) + bias;
  * Dense kernels initialise lecun-normal (truncated, flax's stddev
    correction), biases zero, and the output heads U[0, 3e-3);
  * the critic joins the action after its first layer.

Weights are stored torch-style (Linear.weight is (out, in));
models/from_jax.py converts flax parameter trees into these modules.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
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


class ActorMLP(nn.Module):
    """Deterministic policy mu(s) in [-1, 1]^action_dim (DDPG actor):
    [Dense -> LayerNorm -> relu] x len(hidden), then a tanh head."""

    def __init__(self, obs_dim: int, action_dim: int = 2,
                 hidden: Sequence[int] = (256, 256), generator=None):
        super().__init__()
        self.hidden = tuple(hidden)
        dims = (obs_dim,) + self.hidden
        self.torso = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(LayerNorm(h) for h in self.hidden)
        self.head = nn.Linear(dims[-1], action_dim)
        for layer in self.torso:
            _init_dense(layer, generator)
        _init_dense(self.head, generator, head=True)

    def forward(self, obs):
        x = obs
        for dense, norm in zip(self.torso, self.norms):
            x = torch.relu(norm(dense(x)))
        return torch.tanh(self.head(x))


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
