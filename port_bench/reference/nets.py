"""The cells' networks as plain functions of named parameter tensors, with
Adam and the Polyak average.

A torso is [Dense -> LayerNorm -> relu] per hidden width; LayerNorm takes
eps 1e-6 and the one-pass variance max(E[x^2] - E[x]^2, 0), as flax
computes it. Dense weights are (out, in). Products are float32 (the caller
turns TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

LN_EPS = 1e-6
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def torso_shapes(ins, hidden) -> list:
    """(name, shape, kind) of a torso whose layer i takes ins[i] inputs."""
    out = []
    for i, (a, h) in enumerate(zip(ins, hidden)):
        out += [(f"torso.{i}.weight", (h, a), "dense"),
                (f"torso.{i}.bias", (h,), "zero")]
    for i, h in enumerate(hidden):
        out += [(f"norms.{i}.weight", (h,), "one"),
                (f"norms.{i}.bias", (h,), "zero")]
    return out


def mlp_shapes(obs_dim: int, hidden, out: int, head: str) -> list:
    """An MLP torso and a Dense head of `out` units (`head` is the head
    weight's kind: "dense" or "small")."""
    hidden = tuple(hidden)
    return torso_shapes((obs_dim,) + hidden[:-1], hidden) + [
        ("head.weight", (out, hidden[-1]), head),
        ("head.bias", (out,), "zero")]


def critic_shapes(obs_dim: int, hidden, act_dim: int) -> list:
    """The critic: the action joins the features after the first layer."""
    hidden = tuple(hidden)
    ins = (obs_dim, hidden[0] + act_dim) + hidden[1:-1]
    head_in = hidden[-1] + (act_dim if len(hidden) == 1 else 0)
    return torso_shapes(ins, hidden) + [
        ("head.weight", (1, head_in), "small"),
        ("head.bias", (1,), "zero")]


def _dense(w, b, x):
    return x @ w.t() + b


def _norm(x, s, t):
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + LN_EPS) * s) + t


def _layer(p, i, x):
    z = _dense(p[f"torso.{i}.weight"], p[f"torso.{i}.bias"], x)
    return torch.relu(_norm(z, p[f"norms.{i}.weight"], p[f"norms.{i}.bias"]))


def mlp(p: dict, x, depth: int):
    """The head's outputs of an MLP of `depth` hidden layers."""
    for i in range(depth):
        x = _layer(p, i, x)
    return _dense(p["head.weight"], p["head.bias"], x)


def critic(p: dict, obs, action, depth: int):
    """Q(s, a), (B,)."""
    x = obs
    for i in range(depth):
        x = _layer(p, i, x)
        if i == 0:
            x = torch.cat([x, action], -1)
    return _dense(p["head.weight"], p["head.bias"], x)[:, 0]


def adam_step(p: dict, grads: dict, m: dict, v: dict, count: int,
              lr: float) -> None:
    """One Adam step in place, bias corrections in float32 (count is the
    step's number, from 1)."""
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(count))
    with torch.no_grad():
        for k, g in grads.items():
            m[k].copy_((1 - ADAM_B1) * g + ADAM_B1 * m[k])
            v[k].copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * v[k])
            p[k].add_((m[k] / bc1) / (torch.sqrt(v[k] / bc2) + ADAM_EPS)
                      * -lr)


def polyak(target: dict, online: dict, tau: float) -> None:
    with torch.no_grad():
        for k, t in target.items():
            t.copy_((1.0 - tau) * t + tau * online[k])
