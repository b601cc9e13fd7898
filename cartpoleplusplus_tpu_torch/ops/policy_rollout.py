"""Kernel B2, the DDPG actor in the env loop: its plain torch twin and the
wrapper that launches csrc/policy_rollout.cu.

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
from . import _native
from .fused_rollout import _check_state, _empty_state, _state_ptrs

# Exploration stream tags (agents/common.py re-exports them).
TAG_OU_X = 0x41
TAG_OU_Y = 0x42

_TILE = 32                 # envs per block (kTile in the .cu)


def _smem_bytes(width: int) -> int:
    return 4 * (2 * _TILE * width + 2 * _TILE)


def fusable(env: CartPole3D, hidden: Sequence[int]) -> bool:
    """The kernel covers continuous actions, pose_stack obs with
    auto-reset, 1 to 4 torso layers, and activations of a 32-env tile that
    fit in shared memory. Any batch size: the last tile is masked."""
    p = env.params
    width = max((env.obs_size,) + tuple(hidden)) if hidden else 0
    return (not p.discrete_actions and env.obs_mode == "pose_stack"
            and env.auto_reset
            and 1 <= len(hidden) <= _native.MAX_LAYERS
            and _smem_bytes(width) <= _native.MAX_SMEM)


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


def pack_net(net, head_rows=slice(None)) -> torch.Tensor:
    """A torso net's weights in the rollout kernels' flat layout: per torso
    layer W (in, out) row-major, bias, LayerNorm scale, LayerNorm bias;
    then the head's W (H, out) and bias over `head_rows` of its rows."""
    parts = []
    for dense, norm in zip(net.torso, net.norms):
        parts += [dense.weight.t().reshape(-1), dense.bias, norm.weight,
                  norm.bias]
    parts += [net.head.weight[head_rows].t().reshape(-1),
              net.head.bias[head_rows]]
    return torch.cat([p.detach().float().reshape(-1) for p in parts])


def pack_actor(actor: ActorMLP) -> torch.Tensor:
    """The actor's weights in B2's flat layout (`pack_net`)."""
    return pack_net(actor)


@torch.no_grad()
def policy_rollout(env: CartPole3D, actor: ActorMLP, ou_theta: float,
                   state: EnvState, obs, noise, env_steps: int, sigma: float,
                   num_steps: int):
    """B2: `num_steps` env-steps with the actor in the loop.

    A CUDA state launches the hand-written kernel (csrc/policy_rollout.cu)
    on the current stream; a CPU state runs `reference_policy_rollout`.
    Any other device, or a shape the kernel does not cover, raises."""
    dev = state.steps.device
    if dev.type == "cpu":
        return reference_policy_rollout(env, actor, ou_theta, state, obs,
                                         noise, env_steps, sigma, num_steps)
    if dev.type != "cuda":
        raise ValueError(f"policy_rollout runs on cuda or cpu, not {dev}")
    hidden = actor.hidden
    b, f = env.num_envs, env.obs_size
    if (not fusable(env, hidden) or actor.torso[0].in_features != f
            or actor.head.out_features != 2):
        raise ValueError("env/actor shape not covered by the B2 kernel "
                         "(see ops.policy_rollout.fusable)")
    _check_state(env, state)
    for t, shape in ((obs, (b, f)), (noise, (b, 2))):
        if (t.device != dev or tuple(t.shape) != shape
                or t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"tensor {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}: want contiguous {shape} float32 "
                             f"on {dev}")
    params = pack_actor(actor)
    if params.device != dev:
        raise ValueError(f"actor on {params.device}, env state on {dev}")
    dims = _native.ActorDims(num_layers=len(hidden), obs_dim=f,
                             width=max((f,) + tuple(hidden)))
    for i, h in enumerate(hidden):
        dims.hidden[i] = h
    lib = _native.load_library()
    traj = (torch.empty((num_steps, b, f), dtype=torch.float32, device=dev),
            torch.empty((num_steps, b, 2), dtype=torch.float32, device=dev),
            torch.empty((num_steps, b), dtype=torch.float32, device=dev),
            torch.empty((num_steps, b), dtype=torch.bool, device=dev))
    out = _empty_state(state)
    noise_out = torch.empty_like(noise)
    obs_out = torch.empty_like(obs)
    consts = _native.env_consts(env.params)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cp_policy_rollout(
            _native.struct_ptr(consts), _native.struct_ptr(dims),
            params.data_ptr(), ou_theta, sigma, env_steps, b, num_steps,
            *_state_ptrs(state), state.env_seed.data_ptr(),
            noise.data_ptr(), obs.data_ptr(),
            *(x.data_ptr() for x in traj),
            *_state_ptrs(out), noise_out.data_ptr(), obs_out.data_ptr(),
            stream)
    _native.check(lib, rc, "policy_rollout")
    policy_rollout.launches += 1
    return out, obs_out, noise_out, traj


policy_rollout.launches = 0
