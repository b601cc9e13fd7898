"""Env throughput harness (cartpoleplusplus_tpu/bench/harness.py in
torch).

Env-steps per second of `CartPole3D.step` in a loop (one env-step = the
action map, action_repeats x steps_per_repeat physics substeps, the
observation, termination and reward, and the masked auto-reset), with a
deterministic action stream. Each step's observation and reward are
reduced on the device into a checksum instead of stored; the timing
synchronises by fetching that checksum to the host, as the reference
does. No cell is defined here and nothing is written.
"""

from __future__ import annotations

import time

import torch

from ..env import CartPole3D


def _cheap_actions(env: CartPole3D, t: int, b: int) -> torch.Tensor:
    """Deterministic, nearly free action stream exercising every action:
    (t + i) % 5 on the discrete env, sin(0.37 t + i + (0, 1.57)) on the
    continuous one (float32 throughout)."""
    dev = env.device
    if env.params.discrete_actions:
        return (t + torch.arange(b, dtype=torch.int32, device=dev)) % 5
    phase = (torch.tensor(t, dtype=torch.float32, device=dev) * 0.37)[None] \
        + torch.arange(b, dtype=torch.float32, device=dev)[:, None]
    return torch.sin(phase + torch.tensor([0.0, 1.57], device=dev)[None, :])


def build_rollout(env: CartPole3D, num_steps: int):
    """fn(state) -> (state, checksum): `num_steps` env.steps under
    `_cheap_actions`, checksum = sum over steps of sum(reward) +
    sum(obs[..., 0]), a float32 scalar on the env's device."""

    @torch.no_grad()
    def run(state):
        acc = torch.zeros((), dtype=torch.float32, device=env.device)
        for t in range(num_steps):
            a = _cheap_actions(env, t, env.num_envs)
            state, obs, reward, _, _ = env.step(state, a)
            acc = acc + torch.sum(reward) + torch.sum(obs[..., 0])
        return state, acc

    return run


def measure_env_steps_per_sec(env: CartPole3D, num_steps: int = 512,
                              repeats: int = 8, seed: int = 0,
                              rollout=None) -> dict:
    """Run once (warm-up), then report the best of `repeats` runs."""
    run = rollout if rollout is not None else build_rollout(env, num_steps)
    state, _ = env.reset(seed)

    # Synchronization: the checksum's fetch to the host.
    t0 = time.perf_counter()
    state, acc = run(state)
    checksum = float(acc)
    compile_and_first = time.perf_counter() - t0

    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        state, acc = run(state)
        checksum = float(acc)
        best = min(best, time.perf_counter() - t0)

    steps = env.num_envs * num_steps
    return {
        "env_steps_per_sec": steps / best,
        "substeps_per_sec": steps * env.params.substeps_per_step / best,
        "num_envs": env.num_envs,
        "num_steps": num_steps,
        "best_seconds": best,
        "compile_and_first_seconds": compile_and_first,
        "checksum": checksum,
        "backend": (torch.cuda.get_device_name(env.device)
                    if env.device.type == "cuda" else "cpu"),
    }
