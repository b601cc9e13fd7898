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

import functools
from typing import Sequence

import torch

from ..env.cartpole import CartPole3D, EnvState
from ..models.nets import QNetMLP
from ..utils.prng import hash_words, uniform
from . import _native
from .fused_rollout import _check_state, _empty_state, _state_ptrs

# Exploration stream tags (agents/common.py re-exports them).
TAG_EPS_GATE = 0x43
TAG_EPS_ACT = 0x44
NUM_ACTIONS = 5            # kNumActions in the .cu
_HEAD_LD = 8               # kHeadLd in csrc/q_tile.cuh: padded head width


def q_fusable(env: CartPole3D, hidden: Sequence[int]) -> bool:
    """The kernel covers the discrete 5-action env, pose_stack obs with
    auto-reset, and any torso of at least one layer: any depth, any width
    (activations too wide for shared memory go to a workspace), any batch
    size (the last tile is masked; the reference's multiple-of-1024 rule
    is a TPU layout rule)."""
    p = env.params
    return (p.discrete_actions and env.num_actions == NUM_ACTIONS
            and env.obs_mode == "pose_stack" and env.auto_reset
            and len(hidden) >= 1)


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


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def pack_qnet(q: QNetMLP) -> torch.Tensor:
    """The network's weights in the kernel's flat layout (csrc/q_tile.cuh):
    per torso layer W (in, Np) row-major with Np the width rounded up to 4
    (zero columns), then the head's W (H, 8) (zero columns past 5); then
    per layer bias, LayerNorm scale, LayerNorm bias, and the head's bias.
    Every weight block starts on a 16-byte boundary, as cp.async needs."""
    def padded(w, cols):
        return torch.nn.functional.pad(w.t(), (0, cols - w.shape[0]))

    parts = [padded(d.weight, _pad4(d.out_features)) for d in q.torso]
    parts.append(padded(q.head.weight, _HEAD_LD))
    for dense, norm in zip(q.torso, q.norms):
        parts += [dense.bias, norm.weight, norm.bias]
    parts.append(q.head.bias)
    return torch.cat([p.detach().float().reshape(-1) for p in parts])


def torso_weight_floats(obs_dim: int, hidden: Sequence[int]) -> int:
    """Floats of the padded torso weights at the front of `pack_qnet`."""
    dims = (obs_dim,) + tuple(hidden)
    return sum(a * _pad4(b) for a, b in zip(dims[:-1], dims[1:]))


@functools.lru_cache(maxsize=None)
def _widths(hidden: tuple, dev: torch.device) -> torch.Tensor:
    """The torso widths as the kernel reads them (int32 on the device),
    made once per shape so that a launch copies nothing from the host."""
    return torch.tensor(hidden, dtype=torch.int32, device=dev)


def launch_rollout(entry: str, kernel: str, env: CartPole3D, net, state,
                   obs, num_steps: int, *scalars):
    """Checks the shapes and launches one of the two 5-action rollout
    kernels of csrc/q_rollout.cu (`entry` cp_q_rollout for B4,
    cp_pg_rollout for B8) on the current stream; `scalars` are the entry's
    arguments between the workspace and the batch size. Returns (env
    state', obs', traj)."""
    dev = state.steps.device
    hidden = tuple(net.hidden)
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
    dims = _native.QDims(num_layers=len(hidden), obs_dim=f,
                         width=max((f,) + hidden),
                         wfloats=torso_weight_floats(f, hidden))
    lib = _native.load_library()
    n_work = lib.cp_q_workspace_floats(_native.struct_ptr(dims), b)
    work = (torch.empty(n_work, dtype=torch.float32, device=dev)
            if n_work else None)
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
            params.data_ptr(), _widths(hidden, dev).data_ptr(),
            None if work is None else work.data_ptr(), *scalars, b,
            num_steps, *_state_ptrs(state), state.env_seed.data_ptr(),
            obs.data_ptr(), *(x.data_ptr() for x in traj),
            *_state_ptrs(out), obs_out.data_ptr(), stream)
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
