"""NAF's train step in plain PyTorch (Gu, Lillicrap, Sutskever and Levine,
"Continuous Deep Q-Learning with Model-based Acceleration", arXiv
1603.00748): a rollout of the policy mu with Gaussian exploration, the
replay insert, then, past the warm-up, K updates on column draws: the MSE
TD step toward r + gamma (1 - done) V'(s'), the global-norm gradient clip,
Adam at the scheduled learning rate, and the Polyak average of the target.

One net: a LayerNorm torso and a packed head of 6 rows, [v, mu0, mu1, l0,
l1, l2]. With L = [[softplus(l0), 0], [l1, softplus(l2)]] and u = L^T (a -
mu), Q(s, a) = v - |u|^2 / 2, the paper's V(s) + A(s, a) with A = -(a -
mu)^T P (a - mu) / 2 and P = L L^T.

Departures from the paper, each the configuration's as the program runs
it:

- Q reads the head's raw mu rows, as the kernel learner that the cell
  times computes it; acting takes tanh(mu). The program's plain learner
  (NafNet) applies tanh in Q too, so its arithmetic differs from this on
  purpose; the cell runs the kernel learner.
- L's diagonal is a softplus of its rows, not an exponential, in the
  stable form max(x, 0) + log1p(exp(-|x|)).
- Exploration is a Gaussian of counter-based draws per (env, step),
  scaled by a sigma that decays linearly, the action clipped to [-1, 1];
  no Ornstein-Uhlenbeck state.
- The gradient is clipped to a global norm (optax's rule: g / norm x
  max_norm unless norm < max_norm) before Adam; the learning rate decays
  linearly with Adam's count; the torso has LayerNorm.
- Thousands of envs step in lock-step, and each train step makes K
  updates on minibatches drawn by columns of a per-env ring.
"""

from __future__ import annotations

import numpy as np
import torch

from . import env as E
from .nets import adam_step, mlp, mlp_shapes, polyak
from .prng import normal, split_seed
from .replay import Ring, ring_schedule

TAG_NAF_X = 0x45
TAG_NAF_Y = 0x46
# The packed head's rows: v, mu (2), then L's three entries.
HEAD = 6


def shapes(cfg: dict, obs_dim: int) -> dict:
    """The net's (name, shape, kind) of its weights."""
    return {"net": mlp_shapes(obs_dim, cfg["hidden"], HEAD, "dense")}


# (the first train step that learns, the steps until the ring wraps).
schedule = ring_schedule


def softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def q_value(head, action):
    """Q (B,) from the head's outputs (B, 6) and the actions (B, 2)."""
    da = action - head[:, 1:3]
    u0 = softplus(head[:, 3]) * da[:, 0] + head[:, 4] * da[:, 1]
    u1 = softplus(head[:, 5]) * da[:, 1]
    return head[:, 0] - 0.5 * (u0 * u0 + u1 * u1)


def _f32(x) -> float:
    return float(np.float32(x))


class Reference:
    """Follows a run from its seed and its initial weights ({"net":
    {...}}); the arguments as the DDPG reference takes them."""

    nets = ("net",)

    def __init__(self, cfg: dict, params: E.EnvParams, num_envs: int,
                 weights: dict, seed: int, device, v0: float = 0.0):
        self.cfg, self.p = cfg, params
        self.depth = len(cfg["hidden"])
        self.online = {"net": {k: w.clone().requires_grad_(True)
                               for k, w in weights["net"].items()}}
        self.target = {k: w.clone() for k, w in weights["net"].items()}
        self.m = {"net": {k: torch.zeros_like(w)
                          for k, w in weights["net"].items()}}
        self.v = {k: torch.full_like(w, v0)
                  for k, w in weights["net"].items()}
        self.count = 0
        self.env, self.obs = E.reset(params, split_seed(seed, 3, 1), num_envs,
                                     device)
        self.ring = Ring(num_envs, cfg["replay_capacity_per_env"])
        self.gen = torch.Generator().manual_seed(seed + 1)
        self.env_steps = 0

    def _sigma(self) -> float:
        c = self.cfg
        if c["noise_sigma_decay_env_steps"] <= 0:
            return _f32(c["noise_sigma"])
        frac = (np.float32(self.env_steps)
                / np.float32(c["noise_sigma_decay_env_steps"]))
        frac = min(max(frac, np.float32(0.0)), np.float32(1.0))
        return float(np.float32(c["noise_sigma"]) + frac
                     * np.float32(c["noise_sigma_min"] - c["noise_sigma"]))

    def _lr(self) -> float:
        """The learning rate at Adam's count before this update: linear
        from lr to lr x lr_end_frac over lr_decay_env_steps env-steps,
        counted in updates (K per rollout of rollout_steps)."""
        c = self.cfg
        if c["lr_decay_env_steps"] <= 0:
            return _f32(c["lr"])
        steps = max(c["lr_decay_env_steps"] * c["updates_per_step"]
                    // max(c["rollout_steps"], 1), 1)
        frac = min(np.float32(self.count) / np.float32(steps),
                   np.float32(1.0))
        return float(np.float32(c["lr"]) + frac
                     * np.float32(c["lr"] * c["lr_end_frac"] - c["lr"]))

    @torch.no_grad()
    def _rollout(self):
        sigma, rows = self._sigma(), []
        for i in range(self.cfg["rollout_steps"]):
            t = self.env_steps + i
            mu = torch.tanh(mlp(self.online["net"], self.obs,
                                self.depth)[:, 1:3])
            noise = torch.stack([normal(self.env.env_seed, t, TAG_NAF_X),
                                 normal(self.env.env_seed, t, TAG_NAF_Y)], -1)
            action = torch.clamp(mu + noise * sigma, -1.0, 1.0)
            self.env, nxt, reward, done = E.step(self.p, self.env, action)
            rows.append((self.obs, action, reward, done))
            self.obs = nxt
        return [torch.stack(x) for x in zip(*rows)]

    def _update(self, batch):
        c, d, net = self.cfg, self.depth, self.online["net"]
        obs, action, reward, next_obs, done = batch
        with torch.no_grad():
            v_next = mlp(self.target, next_obs, d)[:, 0]
            y = reward + c["gamma"] * (1.0 - done.to(torch.float32)) * v_next
        loss = torch.mean(torch.square(q_value(mlp(net, obs, d), action) - y))
        names = list(net)
        grads = torch.autograd.grad(loss, [net[k] for k in names])
        if c["max_grad_norm"] > 0.0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if norm >= c["max_grad_norm"]:
                grads = [g / norm * c["max_grad_norm"] for g in grads]
        lr = self._lr()
        self.count += 1
        adam_step(net, dict(zip(names, grads)), self.m["net"], self.v,
                  self.count, lr)
        polyak(self.target, net, c["tau"])
        return loss.item()

    def train_step(self):
        """One train step; the mean loss of its K updates, or None before
        the warm-up has passed."""
        c = self.cfg
        self.ring.add(*self._rollout())
        self.env_steps += c["rollout_steps"]
        if self.env_steps < c["warmup_env_steps"]:
            return None
        batches = self.ring.columns(c["updates_per_step"], c["batch_size"],
                                    self.gen)
        return {"loss": float(np.mean([
            self._update(tuple(x[k] for x in batches))
            for k in range(c["updates_per_step"])]))}
