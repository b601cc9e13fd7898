"""Kernel B4, the DQN Q-net inside the env loop: its plain torch twin and
the wrapper that launches csrc/q_rollout.cu.

Replaces cartpoleplusplus_tpu/ops/policy_rollout.py::_q_rollout_kernel in
its mode `dqn` (its mode `lrpg` is kernel B8, ops/pg_rollout.py, built from
the same CUDA source; its mode `naf` is kernel B6, ops/naf_rollout.py, on
the continuous env). B2, B4, B6 and B8 run one kernel body
(csrc/q_tile.cuh), launched through `launch_rollout` here. Both versions
take

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
from ..utils import spans
from ..utils.prng import hash_words, uniform
from . import _native
from .fused_rollout import _check_state, _empty_state, _state_ptrs

# Exploration stream tags (agents/common.py re-exports them).
TAG_EPS_GATE = 0x43
TAG_EPS_ACT = 0x44
NUM_ACTIONS = 5            # kNumActions in csrc/q_tile.cuh
ACTION_DIM = 2             # kActDim there: B2's and B6's continuous action
_HEAD_LD = 8               # kHeadLd there: padded head width


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


def pack_tile_net(net, head_rows=slice(None)) -> torch.Tensor:
    """A torso net's weights in the rollout kernels' flat layout
    (csrc/q_tile.cuh): per torso layer W (in, Np) row-major with Np the
    width rounded up to 4 (zero columns), then the head's W (H, 8) over
    `head_rows` of its rows (zero columns past them); then per layer bias,
    LayerNorm scale, LayerNorm bias, and the head's bias over `head_rows`.
    Every weight block starts on a 16-byte boundary, as cp.async needs."""
    def padded(w, cols):
        return torch.nn.functional.pad(w.t(), (0, cols - w.shape[0]))

    parts = [padded(d.weight, _pad4(d.out_features)) for d in net.torso]
    parts.append(padded(net.head.weight[head_rows], _HEAD_LD))
    for dense, norm in zip(net.torso, net.norms):
        parts += [dense.bias, norm.weight, norm.bias]
    parts.append(net.head.bias[head_rows])
    return torch.cat([p.detach().float().reshape(-1) for p in parts])


def pack_qnet(q: QNetMLP) -> torch.Tensor:
    """The Q-net's weights in B4's flat layout (`pack_tile_net`, all 5
    head rows)."""
    return pack_tile_net(q)


def torso_weight_floats(obs_dim: int, hidden: Sequence[int]) -> int:
    """Floats of the padded torso weights at the front of
    `pack_tile_net`."""
    dims = (obs_dim,) + tuple(hidden)
    return sum(a * _pad4(b) for a, b in zip(dims[:-1], dims[1:]))


@functools.lru_cache(maxsize=None)
def _widths(hidden: tuple, dev: torch.device) -> torch.Tensor:
    """The torso widths as the kernel reads them (int32 on the device),
    made once per shape so that a launch copies nothing from the host."""
    return torch.tensor(hidden, dtype=torch.int32, device=dev)


def launch_rollout(entry: str, kernel: str, gate, env: CartPole3D, net,
                   state, obs, num_steps: int, *scalars,
                   head_rows=slice(None), noise=None):
    """Checks the shapes and launches one of the rollout kernels that run
    csrc/q_tile.cuh's body (`entry` cp_q_rollout for B4, cp_pg_rollout for
    B8, cp_policy_rollout for B2, cp_naf_rollout for B6) on the current
    stream; `gate` is the kernel's coverage check (`q_fusable`,
    `ops.policy_rollout.fusable`), `scalars` are the entry's arguments
    between the workspace and the batch size. On the discrete env the head
    has 5 outputs and the actions are int32 (T, B); on the continuous env
    `head_rows` selects the head's 2 rows and the actions are float (T, B,
    2); `noise` is B2's OU state (B, 2). Returns (env state', obs', traj),
    with noise' after obs' when `noise` is given."""
    dev = state.steps.device
    with spans.span("cp.prep." + kernel):
        hidden = tuple(net.hidden)
        b, f = env.num_envs, env.obs_size
        discrete = env.params.discrete_actions
        n_out = len(range(net.head.out_features)[head_rows])
        if (not gate(env, hidden) or net.torso[0].in_features != f
                or n_out != (NUM_ACTIONS if discrete else ACTION_DIM)):
            raise ValueError(
                f"env/network shape not covered by the {kernel} kernel (see "
                f"ops.{gate.__module__.split('.')[-1]}.{gate.__name__})")
        _check_state(env, state)
        for t, shape in ((obs, (b, f)),) + (
                () if noise is None else ((noise, (b, ACTION_DIM)),)):
            if (t.device != dev or tuple(t.shape) != shape
                    or t.dtype != torch.float32 or not t.is_contiguous()):
                raise ValueError(f"tensor {tuple(t.shape)} {t.dtype} on "
                                 f"{t.device}: want contiguous {shape} "
                                 f"float32 on {dev}")
        params = pack_tile_net(net, head_rows)
        if params.device != dev:
            raise ValueError(f"network on {params.device}, env state on "
                             f"{dev}")
        dims = _native.QDims(num_layers=len(hidden), obs_dim=f,
                             width=max((f,) + hidden),
                             wfloats=torso_weight_floats(f, hidden))
        lib = _native.load_library()
        n_work = lib.cp_q_workspace_floats(_native.struct_ptr(dims), b)
        work = (torch.empty(n_work, dtype=torch.float32, device=dev)
                if n_work else None)
        act = ((num_steps, b), torch.int32) if discrete else (
            (num_steps, b, ACTION_DIM), torch.float32)
        traj = (torch.empty((num_steps, b, f), dtype=torch.float32,
                            device=dev),
                torch.empty(act[0], dtype=act[1], device=dev),
                torch.empty((num_steps, b), dtype=torch.float32, device=dev),
                torch.empty((num_steps, b), dtype=torch.bool, device=dev))
        out = _empty_state(state)
        obs_out = torch.empty_like(obs)
        noise_io = () if noise is None else (noise, torch.empty_like(noise))
        consts = _native.env_consts(env.params)
        args = (_native.struct_ptr(consts), _native.struct_ptr(dims),
                params.data_ptr(), _widths(hidden, dev).data_ptr(),
                None if work is None else work.data_ptr(), *scalars, b,
                num_steps, *_state_ptrs(state), state.env_seed.data_ptr(),
                *(x.data_ptr() for x in noise_io[:1]), obs.data_ptr(),
                *(x.data_ptr() for x in traj), *_state_ptrs(out),
                *(x.data_ptr() for x in noise_io[1:]), obs_out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args)
    _native.check(lib, rc, entry)
    return (out, obs_out) + noise_io[1:] + (traj,)


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
    out = launch_rollout("cp_q_rollout", "B4", q_fusable, env, q, state,
                         obs, num_steps, eps, env_steps)
    q_policy_rollout.launches += 1
    return out


q_policy_rollout.launches = 0
