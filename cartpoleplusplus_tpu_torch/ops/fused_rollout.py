"""Kernel B1, the physics-only benchmark rollout: its plain torch twin and
the wrapper that launches csrc/fused_rollout.cu.

Replaces cartpoleplusplus_tpu/ops/fused_rollout.py::_rollout_kernel. The
benchmark action stream is a counter-PRNG function of (env seed, step), so
the kernel and `reference_rollout` (the same semantics through the public
env.step) are comparable element for element. The checksum is the sum of
all pre-reset pose frames plus all rewards.
"""

from __future__ import annotations

import torch

from ..env.cartpole import CartPole3D, EnvState
from ..physics import CartPoleParams, PhysState
from ..utils import spans
from ..utils.prng import hash_words, uniform
from . import _native

_TAG_BENCH_ACTION = 0x31


def bench_action_force(p: CartPoleParams, env_seed, t):
    """Deterministic pseudo-random benchmark action -> (fx, fy) forces.
    Discrete: uniform over the 5-way action set; continuous: uniform in
    the [-1, 1]^2 force box."""
    if p.discrete_actions:
        idx = hash_words(env_seed, t, _TAG_BENCH_ACTION) % 5
        fx = (idx == 1).to(torch.float32) - (idx == 2).to(torch.float32)
        fy = (idx == 3).to(torch.float32) - (idx == 4).to(torch.float32)
        return fx * p.action_force, fy * p.action_force
    ax = uniform(-1.0, 1.0, env_seed, t, _TAG_BENCH_ACTION)
    ay = uniform(-1.0, 1.0, env_seed, t, _TAG_BENCH_ACTION + 1)
    return ax * p.action_force, ay * p.action_force


@torch.no_grad()
def reference_rollout(env: CartPole3D, state: EnvState, num_steps: int):
    """The benchmark semantics through env.step: the bench action stream,
    checksum = sum(pre-reset obs frames) + sum(rewards), as float32.
    Returns (final EnvState, checksum)."""
    p = env.params
    acc = torch.zeros((), dtype=torch.float32, device=state.steps.device)
    for t in range(num_steps):
        fx, fy = bench_action_force(p, state.env_seed, t)
        if p.discrete_actions:
            # Invert the force map back to the discrete action index.
            a = (1 * (fx > 0) + 2 * (fx < 0) + 3 * (fy > 0)
                 + 4 * (fy < 0)).to(torch.int32)
        else:
            a = torch.stack([fx, fy], -1) / p.action_force
        state, _, reward, _, info = env.step(state, a)
        acc = acc + info["terminal_obs"].sum() + reward.sum()
    return state, acc


def _check_state(env: CartPole3D, state: EnvState) -> None:
    b = env.num_envs
    want = [(state.phys.pos, (b, 3), torch.float32),
            (state.phys.vel, (b, 3), torch.float32),
            (state.phys.s, (b, 2), torch.float32),
            (state.phys.sd, (b, 2), torch.float32),
            (state.steps, (b,), torch.int32),
            (state.episode, (b,), torch.int32),
            (state.env_seed, (b,), torch.int64)]
    dev = state.steps.device
    for t, shape, dtype in want:
        if (t.device != dev or tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"env state tensor {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}: want contiguous {shape} "
                             f"{dtype} on {dev}")


def _empty_state(state: EnvState) -> EnvState:
    ph = state.phys
    return EnvState(phys=PhysState(*(torch.empty_like(a) for a in ph)),
                    steps=torch.empty_like(state.steps),
                    env_seed=state.env_seed,
                    episode=torch.empty_like(state.episode))


def _state_ptrs(state: EnvState) -> list:
    ph = state.phys
    return [ph.pos.data_ptr(), ph.vel.data_ptr(), ph.s.data_ptr(),
            ph.sd.data_ptr(), state.steps.data_ptr(),
            state.episode.data_ptr()]


def fused_rollout(env: CartPole3D, state: EnvState, num_steps: int):
    """B1: `num_steps` benchmark env-steps -> (final EnvState, checksum).

    A CUDA state launches the hand-written kernel (csrc/fused_rollout.cu,
    one launch) on the current stream; a CPU state runs
    `reference_rollout`. Any other device, or an env the kernel does not
    cover, raises."""
    dev = state.steps.device
    if dev.type == "cpu":
        return reference_rollout(env, state, num_steps)
    if dev.type != "cuda":
        raise ValueError(f"fused_rollout runs on cuda or cpu, not {dev}")
    with spans.span("cp.prep.B1"):
        if env.obs_mode != "pose_stack" or not env.auto_reset:
            raise ValueError("the B1 kernel covers pose_stack envs with "
                             "auto-reset only")
        _check_state(env, state)
        lib = _native.load_library()
        out = _empty_state(state)
        # The per-block checksum partials and the launch's block ticket.
        work = torch.empty(lib.cp_fused_rollout_workspace(env.num_envs),
                           dtype=torch.float64, device=dev)
        checksum = torch.empty((), dtype=torch.float32, device=dev)
        consts = _native.env_consts(env.params)
        args = (_native.struct_ptr(consts), env.num_envs, num_steps,
                *_state_ptrs(state), state.env_seed.data_ptr(),
                *_state_ptrs(out), work.data_ptr(), checksum.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        rc = lib.cp_fused_rollout(*args)
    _native.check(lib, rc, "fused_rollout")
    fused_rollout.launches += 1
    return out, checksum


fused_rollout.launches = 0
