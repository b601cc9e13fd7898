"""Kernel B4, the DQN Q-net inside the env loop: its plain torch twin and
the wrapper that launches csrc/q_rollout.cu.

Replaces cartpoleplusplus_tpu/ops/policy_rollout.py::_q_rollout_kernel in
its mode `dqn` (its mode `lrpg` is kernel B8, ops/pg_rollout.py, built from
the same CUDA source; its mode `naf` is kernel B6, ops/naf_rollout.py, a
mode of B2's continuous-env kernel in csrc/policy_rollout.cu). Both
versions take

    (env state, obs (B, F), Q-net, env_steps, epsilon)

and return

    (env state', obs' (B, F),
     traj = (obs (T, B, F), action (T, B) int32, reward (T, B), done (T, B)))

— the rollout contract of agents/dqn.py. Exploration is epsilon-greedy
with no state between steps: a counter-uniform gate (TAG_EPS_GATE) below
epsilon takes the counter-random action hash % 5 (TAG_EPS_ACT), keyed by
(env seed, global env-step); otherwise the first-max argmax of the 5 Q
values. The actions index the force table noop, +x, -x, +y, -y.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..env.cartpole import CartPole3D, EnvState
from ..models.nets import QNetMLP
from ..utils.prng import hash_words, uniform
from . import _native
from .fused_rollout import _check_state, _empty_state, _state_ptrs
from .policy_rollout import _TILE, pack_actor

# Exploration stream tags (agents/common.py re-exports them).
TAG_EPS_GATE = 0x43
TAG_EPS_ACT = 0x44
NUM_ACTIONS = 5            # kNumActions in the .cu


def _smem_bytes(width: int) -> int:
    return 4 * (2 * _TILE * width + NUM_ACTIONS * _TILE)


def q_fusable(env: CartPole3D, hidden: Sequence[int]) -> bool:
    """The kernel covers the discrete 5-action env, pose_stack obs with
    auto-reset, 1 to 4 torso layers, and activations of a 32-env tile that
    fit in shared memory. Any batch size: the last tile is masked (the
    reference's multiple-of-1024 rule is a TPU layout rule)."""
    p = env.params
    width = max((env.obs_size,) + tuple(hidden)) if hidden else 0
    return (p.discrete_actions and env.num_actions == NUM_ACTIONS
            and env.obs_mode == "pose_stack" and env.auto_reset
            and 1 <= len(hidden) <= _native.MAX_LAYERS
            and _smem_bytes(width) <= _native.MAX_SMEM)


def epsilon_greedy(q_values, env_seed, t: int, eps: float):
    """agents/dqn.py::act on given Q values (B, 5): the counter-random
    action where the gate draw is below eps, else the first-max argmax."""
    greedy = torch.argmax(q_values, dim=-1).to(torch.int32)
    rand = (hash_words(env_seed, t, TAG_EPS_ACT) % NUM_ACTIONS).to(
        torch.int32)
    explore = uniform(0.0, 1.0, env_seed, t, TAG_EPS_GATE) < eps
    return torch.where(explore, rand, greedy)


@torch.no_grad()
def reference_q_rollout(env: CartPole3D, q: QNetMLP, state: EnvState, obs,
                        env_steps: int, eps: float, num_steps: int):
    """The rollout through QNetMLP and env.step — the plain twin of B4."""
    trajs = []
    for i in range(num_steps):
        action = epsilon_greedy(q(obs), state.env_seed, env_steps + i, eps)
        state, next_obs, reward, done, _ = env.step(state, action)
        trajs.append((obs, action, reward, done))
        obs = next_obs
    traj = tuple(torch.stack(x) for x in zip(*trajs))
    return state, obs, traj


def pack_qnet(q: QNetMLP) -> torch.Tensor:
    """The Q-net's weights in the kernel's flat layout, which is B2's
    (`pack_actor`): per torso layer W (in, out) row-major, bias, LayerNorm
    scale, LayerNorm bias; then the head's W (H, 5) and bias."""
    return pack_actor(q)


def launch_rollout(entry: str, kernel: str, env: CartPole3D, net, state,
                   obs, num_steps: int, *scalars):
    """Checks the shapes and launches one of the two 5-action rollout
    kernels of csrc/q_rollout.cu (`entry` cp_q_rollout for B4,
    cp_pg_rollout for B8) on the current stream; `scalars` are the entry's
    arguments between the weights and the batch size. Returns (env state',
    obs', traj)."""
    dev = state.steps.device
    hidden = net.hidden
    b, f = env.num_envs, env.obs_size
    if (not q_fusable(env, hidden) or net.torso[0].in_features != f
            or net.head.out_features != NUM_ACTIONS):
        raise ValueError(f"env/network shape not covered by the {kernel} "
                         f"kernel (see ops.q_rollout.q_fusable)")
    _check_state(env, state)
    if (obs.device != dev or tuple(obs.shape) != (b, f)
            or obs.dtype != torch.float32 or not obs.is_contiguous()):
        raise ValueError(f"obs {tuple(obs.shape)} {obs.dtype} on "
                         f"{obs.device}: want contiguous {(b, f)} float32 "
                         f"on {dev}")
    params = pack_qnet(net)
    if params.device != dev:
        raise ValueError(f"network on {params.device}, env state on {dev}")
    dims = _native.ActorDims(num_layers=len(hidden), obs_dim=f,
                             width=max((f,) + tuple(hidden)))
    for i, h in enumerate(hidden):
        dims.hidden[i] = h
    lib = _native.load_library()
    traj = (torch.empty((num_steps, b, f), dtype=torch.float32, device=dev),
            torch.empty((num_steps, b), dtype=torch.int32, device=dev),
            torch.empty((num_steps, b), dtype=torch.float32, device=dev),
            torch.empty((num_steps, b), dtype=torch.bool, device=dev))
    out = _empty_state(state)
    obs_out = torch.empty_like(obs)
    consts = _native.env_consts(env.params)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            _native.struct_ptr(consts), _native.struct_ptr(dims),
            params.data_ptr(), *scalars, b, num_steps,
            *_state_ptrs(state), state.env_seed.data_ptr(), obs.data_ptr(),
            *(x.data_ptr() for x in traj), *_state_ptrs(out),
            obs_out.data_ptr(), stream)
    _native.check(lib, rc, entry)
    return out, obs_out, traj


@torch.no_grad()
def q_policy_rollout(env: CartPole3D, q: QNetMLP, state: EnvState, obs,
                     env_steps: int, eps: float, num_steps: int):
    """B4: `num_steps` env-steps with the Q-net and epsilon-greedy
    exploration in the loop.

    A CUDA state launches the hand-written kernel (csrc/q_rollout.cu) on
    the current stream; a CPU state runs `reference_q_rollout`. Any other
    device, or a shape the kernel does not cover, raises."""
    dev = state.steps.device
    if dev.type == "cpu":
        return reference_q_rollout(env, q, state, obs, env_steps, eps,
                                   num_steps)
    if dev.type != "cuda":
        raise ValueError(f"q_policy_rollout runs on cuda or cpu, not {dev}")
    out = launch_rollout("cp_q_rollout", "B4", env, q, state, obs,
                         num_steps, eps, env_steps)
    q_policy_rollout.launches += 1
    return out


q_policy_rollout.launches = 0
