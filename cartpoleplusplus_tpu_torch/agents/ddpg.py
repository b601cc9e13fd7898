"""DDPG actor-learner (cartpoleplusplus_tpu/agents/ddpg.py in torch).

One `train_step` runs `rollout_steps` env-steps with the actor and OU
exploration in the loop (kernel B2 on a CUDA device, which raises for a
shape it does not cover; its plain twin on the CPU), inserts the chunk
into the device replay, and then runs `updates_per_step` critic + actor +
Polyak updates on presampled column minibatches. The updates use torch autograd and an Adam written as
optax.adam computes it (bias correction by power, eps added outside the
square root), so a step from a converted reference state reproduces the
reference's XLA learner.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..env import CartPole3D, EnvState
from ..models import ActorMLP, CriticMLP, polyak
from ..ops.policy_rollout import (fusable, policy_rollout,
                                  reference_policy_rollout)
from .common import evaluate_policy, gated_update_scan, replay_presample
from .replay import ReplayBuffer, ReplayState

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """The reference's DDPGConfig, every field kept so that flags and
    configs carry over. `_SUPPORTED` below lists the values the port
    implements; any other value is rejected at construction."""

    hidden: tuple = (256, 256)
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01                # Polyak rate
    batch_size: int = 256            # learner minibatch
    rollout_steps: int = 8           # env-steps per train_step
    updates_per_step: int = 16       # gradient updates per train_step
    replay_capacity_per_env: int = 1024
    ou_theta: float = 0.15           # OU mean-reversion
    ou_sigma: float = 0.2            # OU noise scale
    ou_sigma_min: float = 0.02       # floor after decay
    ou_sigma_decay_env_steps: int = 20000  # linear decay horizon (0 = constant)
    warmup_env_steps: int = 16       # slots to fill before learning starts
    dtype: str = "float32"
    sample: str = "column"
    actor_grad_critic: str = "updated"
    polyak_cadence: str = "per_update"
    # "auto" and "xla" run the plain torch learner; "kernel" (the fused
    # update kernel, B3) is not ported yet.
    learner: str = "auto"
    learner_block: int = 512         # TPU kernel tiling; unused here
    learner_precision: str | None = None
    lr_decay_env_steps: int = 0
    lr_end_frac: float = 0.1
    encoder: str = "conv"            # pixel obs only; not ported yet
    conv_features: tuple = (16, 32, 32)


# Fields whose other values select behaviour the port does not have yet.
_SUPPORTED = {
    "dtype": ("float32",),
    "sample": ("column",),
    "actor_grad_critic": ("updated",),
    "polyak_cadence": ("per_update",),
    "learner": ("auto", "xla"),
    "learner_precision": (None,),
    "lr_decay_env_steps": (0,),
}


class AdamState(NamedTuple):
    """optax ScaleByAdamState: step count and per-parameter moments, in
    `module.parameters()` order."""

    count: int
    mu: list
    nu: list


class DDPGState(NamedTuple):
    actor: ActorMLP
    critic: CriticMLP
    actor_target: ActorMLP
    critic_target: CriticMLP
    actor_opt: AdamState
    critic_opt: AdamState
    replay: ReplayState
    env_state: EnvState
    obs: torch.Tensor          # (B, obs_dim) current observation
    noise: torch.Tensor        # (B, act_dim) OU noise state
    generator: torch.Generator  # replay sampling (CPU)
    env_steps: int             # env-steps taken (per env)


def adam_init(module: torch.nn.Module) -> AdamState:
    zeros = [torch.zeros_like(p) for p in module.parameters()]
    return AdamState(count=0, mu=zeros, nu=[z.clone() for z in zeros])


@torch.no_grad()
def adam_update(module: torch.nn.Module, grads, opt: AdamState,
                lr: float) -> AdamState:
    """One optax.adam step applied to `module`'s parameters in place:
    m = (1-b1) g + b1 m;  v = (1-b2) g^2 + b2 v;
    p += -lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""
    count = opt.count + 1
    # Bias corrections in float32, as optax computes decay**count.
    bc1 = float(np.float32(1.0) - np.float32(_ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(_ADAM_B2) ** np.float32(count))
    mus, nus = [], []
    for p, g, m, v in zip(module.parameters(), grads, opt.mu, opt.nu):
        m = (1 - _ADAM_B1) * g + _ADAM_B1 * m
        v = (1 - _ADAM_B2) * (g * g) + _ADAM_B2 * v
        p.add_((m / bc1) / (torch.sqrt(v / bc2) + _ADAM_EPS) * -lr)
        mus.append(m)
        nus.append(v)
    return AdamState(count=count, mu=mus, nu=nus)


class DDPG:
    """DDPG agent over a batched CartPole3D on one device."""

    def __init__(self, env: CartPole3D, config: DDPGConfig = DDPGConfig()):
        if env.params.discrete_actions:
            raise ValueError("DDPG needs the continuous env "
                             "(CartPoleParams(discrete_actions=False))")
        if config.learner == "kernel":
            raise ValueError("learner='kernel': B3 not ported yet "
                             "(use learner='xla' or 'auto')")
        for name, ok in _SUPPORTED.items():
            if getattr(config, name) not in ok:
                raise ValueError(f"DDPGConfig.{name}="
                                 f"{getattr(config, name)!r} is not ported "
                                 f"yet (supported: {ok})")
        self.env = env
        self.cfg = config
        self._told_plain_rollout = False
        self.replay = ReplayBuffer(env.num_envs,
                                   config.replay_capacity_per_env,
                                   env.obs_size, env.action_dim, env.device)
        # The fused update kernel is not ported, so every learner setting
        # runs the plain torch learner; say so where a kernel was expected.
        if config.learner == "auto" and env.device.type == "cuda":
            print("ddpg: learner=auto resolved to the plain torch update "
                  "loop (the fused update kernel B3 is not ported yet)",
                  file=sys.stderr)

    # --- init ---------------------------------------------------------------
    def init(self, seed: int) -> DDPGState:
        """Fresh state: networks from a torch.Generator seeded with `seed`,
        envs reset with `seed`, empty replay."""
        env, c, dev = self.env, self.cfg, self.env.device
        g = torch.Generator().manual_seed(seed)
        h = tuple(c.hidden)
        actor = ActorMLP(env.obs_size, env.action_dim, h, generator=g).to(dev)
        critic = CriticMLP(env.obs_size, env.action_dim, h,
                           generator=g).to(dev)
        env_state, obs = env.reset(seed)
        return DDPGState(
            actor=actor,
            critic=critic,
            actor_target=copy.deepcopy(actor),
            critic_target=copy.deepcopy(critic),
            actor_opt=adam_init(actor),
            critic_opt=adam_init(critic),
            replay=self.replay.init(),
            env_state=env_state,
            obs=obs,
            noise=torch.zeros((env.num_envs, env.action_dim),
                              dtype=torch.float32, device=dev),
            generator=torch.Generator().manual_seed(seed + 1),
            env_steps=0)

    # --- acting -------------------------------------------------------------
    def fusable(self) -> bool:
        """Whether kernel B2 covers this env/config shape."""
        return fusable(self.env, tuple(self.cfg.hidden))

    def _sigma(self, env_steps: int) -> float:
        """OU sigma, decayed linearly in float32 as the reference does."""
        c = self.cfg
        if c.ou_sigma_decay_env_steps <= 0:
            return float(np.float32(c.ou_sigma))
        frac = np.float32(env_steps) / np.float32(c.ou_sigma_decay_env_steps)
        frac = min(max(frac, np.float32(0.0)), np.float32(1.0))
        return float(np.float32(c.ou_sigma)
                     + frac * np.float32(c.ou_sigma_min - c.ou_sigma))

    # --- learning -----------------------------------------------------------
    def _critic_loss(self, critic, actor_target, critic_target, batch):
        obs, action, reward, next_obs, done = batch
        c = self.cfg
        with torch.no_grad():
            a_next = actor_target(next_obs)
            q_next = critic_target(next_obs, a_next)
            y = reward + c.gamma * (1.0 - done.to(torch.float32)) * q_next
        q = critic(obs, action)
        return torch.mean(torch.square(q - y))

    def _actor_loss(self, actor, critic, obs):
        return -torch.mean(critic(obs, actor(obs)))

    def _update_once(self, st: DDPGState, batch):
        """Critic TD step, actor step through the UPDATED critic, then
        Polyak on both targets."""
        c = self.cfg
        closs = self._critic_loss(st.critic, st.actor_target,
                                  st.critic_target, batch)
        cgrad = torch.autograd.grad(closs, list(st.critic.parameters()))
        copt = adam_update(st.critic, cgrad, st.critic_opt, c.critic_lr)
        aloss = self._actor_loss(st.actor, st.critic, batch[0])
        agrad = torch.autograd.grad(aloss, list(st.actor.parameters()))
        aopt = adam_update(st.actor, agrad, st.actor_opt, c.actor_lr)
        polyak(st.actor_target, st.actor, c.tau)
        polyak(st.critic_target, st.critic, c.tau)
        st = st._replace(actor_opt=aopt, critic_opt=copt)
        return st, {"critic_loss": closs.detach(),
                    "actor_loss": aloss.detach()}

    def evaluate(self, st: DDPGState, num_steps: int = 200, seed: int = 0):
        """Deterministic-actor evaluation (no OU noise): episode stats."""
        return evaluate_policy(self.env, st.actor, seed, num_steps)

    # --- the actor-learner step ---------------------------------------------
    def train_step(self, st: DDPGState, fused=None, indices=None):
        """rollout_steps env-steps + replay insert + updates_per_step
        gradient updates. Networks and the replay ring are updated in
        place; the returned state carries the new counters and tensors.

        fused: None or True runs the rollout through B2's wrapper, which
        launches the kernel for CUDA tensors (and raises for a shape the
        kernel does not cover) and runs the plain twin for CPU tensors.
        False runs the plain twin on any device; on a GPU it says so once
        on stderr. `rollout_impl` reports which ran. indices: optional
        (slots, offs) for the presample, in place of the state's
        generator."""
        c = self.cfg
        sigma = self._sigma(st.env_steps)
        on_gpu = self.env.device.type == "cuda"
        if fused is False and on_gpu and not self._told_plain_rollout:
            print("ddpg: fused=False runs the plain torch rollout on the "
                  "GPU, not kernel B2", file=sys.stderr)
            self._told_plain_rollout = True
        run = reference_policy_rollout if fused is False else policy_rollout
        env_state, obs, noise, traj = run(
            self.env, st.actor, c.ou_theta, st.env_state, st.obs, st.noise,
            st.env_steps, sigma, c.rollout_steps)
        replay = self.replay.add_trajectory(st.replay, *traj)
        env_steps = st.env_steps + c.rollout_steps
        st = st._replace(env_state=env_state, obs=obs, noise=noise,
                         replay=replay, env_steps=env_steps)
        ready = c.warmup_env_steps <= 0 or env_steps >= c.warmup_env_steps
        zero = torch.zeros((), dtype=torch.float32, device=self.env.device)
        st, losses = gated_update_scan(
            st, self._update_once, c.updates_per_step, ready,
            {"critic_loss": zero, "actor_loss": zero},
            presample=replay_presample(self.replay, c.batch_size, indices))
        metrics = dict(losses)
        metrics["reward_mean"] = traj[2].mean()
        metrics["done_frac"] = traj[3].to(torch.float32).mean()
        metrics["env_steps"] = env_steps
        # 1.0 = kernel B2 ran the rollout, 0.0 = the plain twin did.
        metrics["rollout_impl"] = float(on_gpu and fused is not False)
        # 1.0 = fused update kernel, 0.0 = plain learner (always, until B3).
        metrics["learner_impl"] = 0.0
        return st, metrics
