"""DDPG's train step in plain PyTorch: a rollout of the actor with
Ornstein-Uhlenbeck exploration, the replay insert, then, past the warm-up,
K updates on column draws: the critic's TD step, the actor's step through
the updated critic, Adam on each, and the Polyak average of both targets.
"""

from __future__ import annotations

import numpy as np
import torch

from . import env as E
from .nets import (adam_step, critic, critic_shapes, mlp, mlp_shapes,
                   polyak)
from .prng import split_seed
from .replay import Ring, ring_schedule


def shapes(cfg: dict, obs_dim: int) -> dict:
    """Each net's (name, shape, kind) of its weights: the actor's tanh head
    and the critic's head start small."""
    return {"actor": mlp_shapes(obs_dim, cfg["hidden"], 2, "small"),
            "critic": critic_shapes(obs_dim, cfg["hidden"], 2)}


# (the first train step that learns, the steps until the ring wraps).
schedule = ring_schedule


class Reference:
    """Follows a run from its seed and its initial weights.

    cfg: the configuration's `agent` object with the traffic's overrides;
    params: the env's EnvParams; weights: {"actor": {...}, "critic": {...}}
    named tensors on the device (copied; the targets start as copies);
    v0: every element's starting Adam second moment (first moments start
    at zero)."""

    nets = ("actor", "critic")

    def __init__(self, cfg: dict, params: E.EnvParams, num_envs: int,
                 weights: dict, seed: int, device, v0: float = 0.0):
        self.cfg, self.p = cfg, params
        self.depth = len(cfg["hidden"])
        self.online = {n: {k: w.clone().requires_grad_(True)
                           for k, w in weights[n].items()} for n in self.nets}
        self.target = {n: {k: w.clone() for k, w in weights[n].items()}
                       for n in self.nets}
        self.m = {n: {k: torch.zeros_like(w) for k, w in weights[n].items()}
                  for n in self.nets}
        self.v = {n: {k: torch.full_like(w, v0) for k, w in weights[n].items()}
                  for n in self.nets}
        self.count = 0
        self.env, self.obs = E.reset(params, split_seed(seed, 4, 2), num_envs,
                                     device)
        self.noise = torch.zeros((num_envs, 2), device=device)
        self.ring = Ring(num_envs, cfg["replay_capacity_per_env"])
        self.gen = torch.Generator().manual_seed(seed + 1)
        self.env_steps = 0

    def _sigma(self) -> float:
        c = self.cfg
        if c["ou_sigma_decay_env_steps"] <= 0:
            return float(np.float32(c["ou_sigma"]))
        frac = (np.float32(self.env_steps)
                / np.float32(c["ou_sigma_decay_env_steps"]))
        frac = min(max(frac, np.float32(0.0)), np.float32(1.0))
        return float(np.float32(c["ou_sigma"]) + frac
                     * np.float32(c["ou_sigma_min"] - c["ou_sigma"]))

    def _actor(self, p, obs):
        return torch.tanh(mlp(p, obs, self.depth))

    @torch.no_grad()
    def _rollout(self):
        c, sigma, rows = self.cfg, self._sigma(), []
        for i in range(c["rollout_steps"]):
            self.noise = E.ou_noise(self.noise, self.env.env_seed,
                                    self.env_steps + i, c["ou_theta"], sigma)
            action = torch.clamp(self._actor(self.online["actor"], self.obs)
                                 + self.noise, -1.0, 1.0)
            self.env, nxt, reward, done = E.step(self.p, self.env, action)
            self.noise = torch.where(done[:, None], 0.0, self.noise)
            rows.append((self.obs, action, reward, done))
            self.obs = nxt
        return [torch.stack(x) for x in zip(*rows)]

    def _update(self, batch):
        c, d = self.cfg, self.depth
        obs, action, reward, next_obs, done = batch
        on, tg = self.online, self.target
        with torch.no_grad():
            q_next = critic(tg["critic"], next_obs,
                            self._actor(tg["actor"], next_obs), d)
            y = reward + c["gamma"] * (1.0 - done.to(torch.float32)) * q_next
        closs = torch.mean(torch.square(critic(on["critic"], obs, action, d)
                                        - y))
        names = list(on["critic"])
        grads = torch.autograd.grad(closs, [on["critic"][k] for k in names])
        self.count += 1
        adam_step(on["critic"], dict(zip(names, grads)), self.m["critic"],
                  self.v["critic"], self.count, c["critic_lr"])
        aloss = -torch.mean(critic(on["critic"], obs,
                                   self._actor(on["actor"], obs), d))
        names = list(on["actor"])
        grads = torch.autograd.grad(aloss, [on["actor"][k] for k in names])
        adam_step(on["actor"], dict(zip(names, grads)), self.m["actor"],
                  self.v["actor"], self.count, c["actor_lr"])
        for n in self.nets:
            polyak(tg[n], on[n], c["tau"])
        return closs.item(), aloss.item()

    def train_step(self):
        """One train step; the mean losses of its K updates, or None before
        the warm-up has passed."""
        c = self.cfg
        self.ring.add(*self._rollout())
        self.env_steps += c["rollout_steps"]
        if self.env_steps < c["warmup_env_steps"]:
            return None
        batches = self.ring.columns(c["updates_per_step"], c["batch_size"],
                                    self.gen)
        losses = [self._update(tuple(x[k] for x in batches))
                  for k in range(c["updates_per_step"])]
        return {"critic_loss": float(np.mean([x[0] for x in losses])),
                "actor_loss": float(np.mean([x[1] for x in losses]))}
