"""Double DQN's train step in plain PyTorch: an epsilon-greedy rollout of
the Q-net, the replay insert, then, past the warm-up, K updates on column
draws: the Huber TD step toward r + gamma (1 - done) Q'(s', argmax_a Q(s',
a)), Adam, and the Polyak average of the target.
"""

from __future__ import annotations

import numpy as np
import torch

from . import env as E
from .nets import adam_step, mlp, mlp_shapes, polyak
from .prng import split_seed
from .replay import Ring, ring_schedule


def huber(pred, target, delta: float = 1.0):
    err = torch.abs(pred - target)
    quad = torch.clamp(err, max=delta)
    return 0.5 * quad * quad + delta * (err - quad)


def shapes(cfg: dict, obs_dim: int) -> dict:
    """The Q-net's (name, shape, kind) of its weights."""
    return {"q": mlp_shapes(obs_dim, cfg["hidden"], E.NUM_ACTIONS, "dense")}


# (the first train step that learns, the steps until the ring wraps).
schedule = ring_schedule


class Reference:
    """Follows a run from its seed and its initial weights ({"q": {...}});
    the arguments as the DDPG reference takes them."""

    nets = ("q",)

    def __init__(self, cfg: dict, params: E.EnvParams, num_envs: int,
                 weights: dict, seed: int, device, v0: float = 0.0):
        self.cfg, self.p = cfg, params
        self.depth = len(cfg["hidden"])
        self.online = {"q": {k: w.clone().requires_grad_(True)
                             for k, w in weights["q"].items()}}
        self.target = {k: w.clone() for k, w in weights["q"].items()}
        self.m = {"q": {k: torch.zeros_like(w)
                        for k, w in weights["q"].items()}}
        self.v = {k: torch.full_like(w, v0) for k, w in weights["q"].items()}
        self.count = 0
        self.env, self.obs = E.reset(params, split_seed(seed, 3, 1), num_envs,
                                     device)
        self.ring = Ring(num_envs, cfg["replay_capacity_per_env"])
        self.gen = torch.Generator().manual_seed(seed + 1)
        self.env_steps = 0

    def _epsilon(self) -> float:
        c = self.cfg
        if c["eps_decay_env_steps"] <= 0:
            return float(np.float32(c["eps_end"]))
        frac = (np.float32(self.env_steps)
                / np.float32(c["eps_decay_env_steps"]))
        frac = min(max(frac, np.float32(0.0)), np.float32(1.0))
        return float(np.float32(c["eps_start"]) + frac
                     * np.float32(c["eps_end"] - c["eps_start"]))

    @torch.no_grad()
    def _rollout(self):
        c, eps, rows = self.cfg, self._epsilon(), []
        for i in range(c["rollout_steps"]):
            action = E.epsilon_greedy(
                mlp(self.online["q"], self.obs, self.depth),
                self.env.env_seed, self.env_steps + i, eps)
            self.env, nxt, reward, done = E.step(self.p, self.env, action)
            rows.append((self.obs, action, reward, done))
            self.obs = nxt
        return [torch.stack(x) for x in zip(*rows)]

    def _update(self, batch):
        c, d, q = self.cfg, self.depth, self.online["q"]
        obs, action, reward, next_obs, done = batch
        with torch.no_grad():
            q_t = mlp(self.target, next_obs, d)
            if c["double_dqn"]:
                best = torch.argmax(mlp(q, next_obs, d), -1, keepdim=True)
                q_next = q_t.gather(1, best)[:, 0]
            else:
                q_next = q_t.max(-1).values
            y = reward + c["gamma"] * (1.0 - done.to(torch.float32)) * q_next
        q_sa = mlp(q, obs, d).gather(1, action.long()[:, None])[:, 0]
        loss = torch.mean(huber(q_sa, y))
        names = list(q)
        grads = torch.autograd.grad(loss, [q[k] for k in names])
        self.count += 1
        adam_step(q, dict(zip(names, grads)), self.m["q"], self.v,
                  self.count, c["lr"])
        polyak(self.target, q, c["tau"])
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
