"""Kernel B8, the LRPG softmax policy inside the env loop: its plain torch
twin and the wrapper that launches it.

Replaces cartpoleplusplus_tpu/ops/policy_rollout.py::_q_rollout_kernel in
its mode `lrpg` (the Pallas TPU kernel built by pg_policy_rollout). The
Pallas function runs B4 and B8 as two modes of one body, and so does the
port: B8 is the second entry point of csrc/q_rollout.cu, the exploration
rule a compile-time mode of B4's kernel. This module keeps B8's Python
side apart from B4's (ops/q_rollout.py) because its twin, tag and wrapper
are the LRPG agent's, and it reuses B4's launcher and shape window.

Both versions take

    (env state, obs (B, F), PolicyMLP, env_steps)

and return

    (env state', obs' (B, F),
     traj = (obs (T, B, F), action (T, B) int32, reward (T, B), done (T, B)))

— the rollout contract of agents/lrpg.py. The action is an exact softmax
sample by Gumbel-max: the first-max argmax of logits[a] + gumbel(env seed,
global env-step, TAG_PG_GUMBEL, a), a pure function of the counters, so
both versions draw the same samples.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..env.cartpole import CartPole3D, EnvState
from ..models.nets import PolicyMLP
from ..utils.prng import gumbel
from .q_rollout import NUM_ACTIONS, launch_rollout, q_fusable

# Exploration stream tag (agents/common.py re-exports it).
TAG_PG_GUMBEL = 0x47


def pg_fusable(env: CartPole3D, hidden: Sequence[int]) -> bool:
    """B8 covers what B4 covers (`q_fusable`): PolicyMLP has QNetMLP's
    torso and 5-wide linear head."""
    return q_fusable(env, hidden)


def gumbel_scores(logits, env_seed, t: int):
    """logits (B, 5) + one counter-Gumbel draw per (env seed, step t,
    action): the scores whose first-max argmax is the sample."""
    g = torch.stack([gumbel(env_seed, t, TAG_PG_GUMBEL, a)
                     for a in range(NUM_ACTIONS)], dim=-1)
    return logits + g


def gumbel_max(logits, env_seed, t: int):
    """agents/lrpg.py::act on given logits (B, 5): an exact softmax
    sample, the first-max argmax of `gumbel_scores`."""
    return torch.argmax(gumbel_scores(logits, env_seed, t),
                        dim=-1).to(torch.int32)


@torch.no_grad()
def reference_pg_rollout(env: CartPole3D, policy: PolicyMLP,
                         state: EnvState, obs, env_steps: int,
                         num_steps: int):
    """The rollout through PolicyMLP and env.step — the plain twin of B8."""
    trajs = []
    for i in range(num_steps):
        action = gumbel_max(policy(obs), state.env_seed, env_steps + i)
        state, next_obs, reward, done, _ = env.step(state, action)
        trajs.append((obs, action, reward, done))
        obs = next_obs
    traj = tuple(torch.stack(x) for x in zip(*trajs))
    return state, obs, traj


@torch.no_grad()
def pg_policy_rollout(env: CartPole3D, policy: PolicyMLP, state: EnvState,
                      obs, env_steps: int, num_steps: int):
    """B8: `num_steps` env-steps with the softmax policy sampled in the
    loop.

    A CUDA state launches the hand-written kernel (entry cp_pg_rollout of
    csrc/q_rollout.cu) on the current stream; a CPU state runs
    `reference_pg_rollout`. Any other device, or a shape the kernel does
    not cover, raises."""
    dev = state.steps.device
    if dev.type == "cpu":
        return reference_pg_rollout(env, policy, state, obs, env_steps,
                                    num_steps)
    if dev.type != "cuda":
        raise ValueError(f"pg_policy_rollout runs on cuda or cpu, not {dev}")
    out = launch_rollout("cp_pg_rollout", "B8", pg_fusable, env, policy,
                         state, obs, num_steps, env_steps)
    pg_policy_rollout.launches += 1
    return out


pg_policy_rollout.launches = 0
