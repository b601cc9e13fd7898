"""Kernel B6, the NAF mu head with Gaussian exploration inside the env loop:
its plain torch twin and the wrapper that launches it.

Replaces cartpoleplusplus_tpu/ops/policy_rollout.py::_q_rollout_kernel in
its mode `naf` (the Pallas TPU kernel built by naf_policy_rollout). The
Pallas function runs B6 as a mode of B4's body; the port runs B2, B4, B6
and B8 as compile-time modes of one body (csrc/q_tile.cuh). B6 is the
second entry point of csrc/policy_rollout.cu (`cp_naf_rollout`), on B2's
continuous env and 2-wide tanh head, and it covers B2's shape window, as
the reference's `naf_fusable` does.

Both versions take

    (env state, obs (B, F), NafNet, env_steps, sigma)

and return

    (env state', obs' (B, F),
     traj = (obs (T, B, F), action (T, B, 2), reward (T, B), done (T, B)))

— the rollout contract of agents/naf.py. The action is clip(tanh(mu(s)) +
sigma * (normal(env seed, global env-step, TAG_NAF_X), normal(..,
TAG_NAF_Y)), -1, 1): a pure function of the counters, with no noise state
between steps, so both versions draw the same noise.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..env.cartpole import CartPole3D, EnvState
from ..models.nets import NafNet
from ..utils.prng import normal
from .policy_rollout import fusable
from .q_rollout import launch_rollout, pack_tile_net

# Exploration stream tags (agents/common.py re-exports them).
TAG_NAF_X = 0x45
TAG_NAF_Y = 0x46
_MU_ROWS = slice(1, 3)     # NafNet's packed head: [v, mu0, mu1, l0, l1, l2]


def naf_fusable(env: CartPole3D, hidden: Sequence[int]) -> bool:
    """B6 covers what B2 covers (`ops.policy_rollout.fusable`): the same
    continuous env, torso and 2-wide tanh head."""
    return fusable(env, hidden)


def naf_action(mu, env_seed, t: int, sigma: float):
    """agents/naf.py::act on given mu (B, 2): mu plus sigma times counter
    normals keyed by (env seed, step t), clipped to [-1, 1]."""
    eps = torch.stack([normal(env_seed, t, TAG_NAF_X),
                       normal(env_seed, t, TAG_NAF_Y)], dim=-1) * sigma
    return torch.clamp(mu + eps, -1.0, 1.0)


@torch.no_grad()
def reference_naf_rollout(env: CartPole3D, net: NafNet, state: EnvState,
                          obs, env_steps: int, sigma: float, num_steps: int):
    """The rollout through NafNet's mu and env.step — the plain twin of B6."""
    trajs = []
    for i in range(num_steps):
        action = naf_action(net(obs)[1], state.env_seed, env_steps + i,
                            sigma)
        state, next_obs, reward, done, _ = env.step(state, action)
        trajs.append((obs, action, reward, done))
        obs = next_obs
    traj = tuple(torch.stack(x) for x in zip(*trajs))
    return state, obs, traj


def pack_naf_mu(net: NafNet) -> torch.Tensor:
    """The torso and the mu rows (1 and 2) of the packed head in B2's flat
    layout (`pack_tile_net`). The V and L rows are the learner's only."""
    return pack_tile_net(net, _MU_ROWS)


@torch.no_grad()
def naf_policy_rollout(env: CartPole3D, net: NafNet, state: EnvState, obs,
                       env_steps: int, sigma: float, num_steps: int):
    """B6: `num_steps` env-steps with NAF's mu and Gaussian exploration in
    the loop.

    A CUDA state launches the hand-written kernel (entry cp_naf_rollout of
    csrc/policy_rollout.cu, through `ops.q_rollout.launch_rollout`) on the
    current stream; a CPU state runs `reference_naf_rollout`. Any other
    device, or a shape the kernel does not cover, raises."""
    dev = state.steps.device
    if dev.type == "cpu":
        return reference_naf_rollout(env, net, state, obs, env_steps, sigma,
                                     num_steps)
    if dev.type != "cuda":
        raise ValueError(f"naf_policy_rollout runs on cuda or cpu, not {dev}")
    out = launch_rollout("cp_naf_rollout", "B6", naf_fusable, env, net,
                         state, obs, num_steps, sigma, env_steps,
                         head_rows=_MU_ROWS)
    naf_policy_rollout.launches += 1
    return out


naf_policy_rollout.launches = 0
