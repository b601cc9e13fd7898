"""Kernel B2, the DDPG actor in the env loop: its plain torch twin and the
wrapper that launches csrc/policy_rollout.cu (entry cp_policy_rollout, mode
kModeDdpg of the rollout body in csrc/q_tile.cuh that B4, B6 and B8 share).

Replaces cartpoleplusplus_tpu/ops/policy_rollout.py::_policy_rollout_kernel.
Both versions take

    (env state, obs (B, F), noise (B, 2), actor, env_steps, sigma)

and return

    (env state', obs' (B, F), noise' (B, 2),
     traj = (obs (T, B, F), action (T, B, 2), reward (T, B), done (T, B)))

— the carry/trajectory contract of agents/ddpg.py's rollout. Exploration
is Ornstein-Uhlenbeck noise driven by counter normals keyed by (env seed,
global env-step), so both versions draw the same noise; the OU state of a
finished env restarts at 0.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..env.cartpole import CartPole3D, EnvState
from ..models.nets import ActorMLP
from ..utils.prng import normal
from .q_rollout import launch_rollout, pack_tile_net

# Exploration stream tags (agents/common.py re-exports them).
TAG_OU_X = 0x41
TAG_OU_Y = 0x42


def fusable(env: CartPole3D, hidden: Sequence[int]) -> bool:
    """The kernel covers continuous actions, pose_stack obs with
    auto-reset, and any torso of at least one layer: any depth, any width
    (activations too wide for shared memory go to a workspace), any batch
    size (the last tile is masked; the reference's multiple-of-1024 rule
    is a TPU layout rule)."""
    p = env.params
    return (not p.discrete_actions and env.obs_mode == "pose_stack"
            and env.auto_reset and len(hidden) >= 1)


def ou_step(noise, env_seed, t: int, theta: float, sigma: float):
    """One OU update with counter normals keyed by (env seed, step t)."""
    eps = torch.stack([normal(env_seed, t, TAG_OU_X),
                       normal(env_seed, t, TAG_OU_Y)], dim=-1)
    return noise + theta * (0.0 - noise) + sigma * eps


@torch.no_grad()
def reference_policy_rollout(env: CartPole3D, actor: ActorMLP,
                             ou_theta: float, state: EnvState, obs, noise,
                             env_steps: int, sigma: float, num_steps: int):
    """The rollout through ActorMLP and env.step — the plain twin of B2."""
    trajs = []
    for i in range(num_steps):
        noise = ou_step(noise, state.env_seed, env_steps + i, ou_theta,
                        sigma)
        action = torch.clamp(actor(obs) + noise, -1.0, 1.0)
        state, next_obs, reward, done, _ = env.step(state, action)
        noise = torch.where(done[:, None], 0.0, noise)
        trajs.append((obs, action, reward, done))
        obs = next_obs
    traj = tuple(torch.stack(x) for x in zip(*trajs))
    return state, obs, noise, traj


def pack_actor(actor: ActorMLP) -> torch.Tensor:
    """The actor's weights in B2's flat layout (`pack_tile_net`, both head
    rows)."""
    return pack_tile_net(actor)


@torch.no_grad()
def policy_rollout(env: CartPole3D, actor: ActorMLP, ou_theta: float,
                   state: EnvState, obs, noise, env_steps: int, sigma: float,
                   num_steps: int):
    """B2: `num_steps` env-steps with the actor in the loop.

    A CUDA state launches the hand-written kernel (csrc/policy_rollout.cu,
    through `ops.q_rollout.launch_rollout`) on the current stream; a CPU
    state runs `reference_policy_rollout`. Any other device, or a shape
    the kernel does not cover, raises."""
    dev = state.steps.device
    if dev.type == "cpu":
        return reference_policy_rollout(env, actor, ou_theta, state, obs,
                                         noise, env_steps, sigma, num_steps)
    if dev.type != "cuda":
        raise ValueError(f"policy_rollout runs on cuda or cpu, not {dev}")
    out = launch_rollout("cp_policy_rollout", "B2", fusable, env, actor,
                         state, obs, num_steps, ou_theta, sigma, env_steps,
                         noise=noise)
    policy_rollout.launches += 1
    return out


policy_rollout.launches = 0
