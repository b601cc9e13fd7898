"""Vectorized 3D cart-pole environment
(cartpoleplusplus_tpu/env/cartpole.py in torch, `pose_stack` and `state`
observations).

The batch axis is built into every tensor: one `step` advances all envs by
R action-repeats x S physics substeps, assembles the observation, and
resets finished envs in place of a per-env `reset()` (masked auto-reset).
Randomness is a pure function of (per-env seed, episode, step), with
per-env seeds derived from the global env index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..physics import CartPoleParams, PhysState, run_substeps
from ..utils.prng import as_words, hash_words
from . import compute
from .obs import OBS_MODES, obs_size, pose_frame, stack_obs, state_obs

# Discrete action -> force direction table (noop, +x, -x, +y, -y).
_ACTION_TABLE = ((0.0, 0.0), (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0),
                 (0.0, -1.0))


class EnvState(NamedTuple):
    """Full per-env state. Leaves have leading batch dim (B,)."""

    phys: PhysState        # physical coordinates
    steps: torch.Tensor    # (B,) int32 — steps elapsed in current episode
    env_seed: torch.Tensor  # (B,) int64 in [0, 2**32) — per-env PRNG seed
    episode: torch.Tensor  # (B,) int32 — episode counter


def derive_env_seeds(seed: int, num_envs: int, index_offset: int = 0,
                     device=None) -> torch.Tensor:
    """Per-env seeds from (global seed, global env index), independent of
    batch slot. Integer seeds only."""
    idx = as_words(torch.arange(num_envs, dtype=torch.int64, device=device)
                   + index_offset)
    return hash_words(seed & 0xFFFFFFFF, idx)


def _reset_phys(p: CartPoleParams, env_seed, episode) -> PhysState:
    """Fresh episode state: upright rest pose + random push impulse."""
    c = compute.reset_components(p, env_seed, episode)
    return PhysState(pos=torch.stack(c[0:3], dim=-1),
                     vel=torch.stack(c[3:6], dim=-1),
                     s=torch.stack(c[6:8], dim=-1),
                     sd=torch.stack(c[8:10], dim=-1))


def _map_action(p: CartPoleParams, action) -> torch.Tensor:
    """Agent action -> cart force (B, 2)."""
    if p.discrete_actions:
        table = torch.tensor(_ACTION_TABLE, dtype=torch.float32,
                             device=action.device)
        return table[action.long()] * p.action_force
    return torch.clamp(action, -1.0, 1.0) * p.action_force


class CartPole3D:
    """Batched env on one device. `self` carries static configuration only.

    Usage:
        env = CartPole3D(CartPoleParams(), num_envs=4096, device="cuda")
        state, obs = env.reset(0)
        state, obs, reward, done, info = env.step(state, action)
    """

    def __init__(self, params: CartPoleParams = CartPoleParams(),
                 num_envs: int = 1, obs_mode: str = "pose_stack",
                 auto_reset: bool = True, device="cpu"):
        if obs_mode not in OBS_MODES:
            raise ValueError(f"obs_mode must be one of {OBS_MODES} "
                             "(pixels are not ported yet)")
        self.params = params
        self.num_envs = num_envs
        self.obs_mode = obs_mode
        self.auto_reset = auto_reset
        self.device = torch.device(device)

    # --- spaces ------------------------------------------------------------
    @property
    def num_actions(self) -> int:
        """5 for the discrete variant (noop/+-x/+-y)."""
        return 5 if self.params.discrete_actions else 0

    @property
    def action_dim(self) -> int:
        """2 for the continuous variant (fx, fy in [-1, 1])."""
        return 0 if self.params.discrete_actions else 2

    @property
    def obs_size(self) -> int:
        return obs_size(self.params, self.obs_mode)

    @property
    def obs_shape(self) -> tuple:
        return (self.obs_size,)

    # --- episode API ---------------------------------------------------------
    def reset(self, seed: int, index_offset: int = 0):
        """Fresh state for all envs; per-env seeds from the global index."""
        b = self.num_envs
        env_seed = derive_env_seeds(seed, b, index_offset, self.device)
        episode = torch.zeros((b,), dtype=torch.int32, device=self.device)
        phys = _reset_phys(self.params, env_seed, episode)
        state = EnvState(phys=phys, steps=torch.zeros_like(episode),
                         env_seed=env_seed, episode=episode)
        return state, self._initial_obs(phys)

    def _initial_obs(self, phys: PhysState) -> torch.Tensor:
        if self.obs_mode == "state":
            return state_obs(self.params, phys)
        # A fresh episode's observation repeats the initial pose across
        # the repeat window.
        frame = pose_frame(self.params, phys)
        return stack_obs([frame] * self.params.action_repeats)

    def step(self, state: EnvState, action):
        """One env-step: R action-repeats x S physics substeps, pose
        snapshot per repeat, termination, reward, masked auto-reset."""
        p = self.params
        force = _map_action(p, action)
        phys = state.phys

        frames = []
        for r in range(p.action_repeats):
            if p.push_prob_per_repeat > 0.0:
                px, py = compute.push_xy(p, state.env_seed, state.episode,
                                         state.steps, r)
                push = torch.stack([px, py], dim=-1)
            else:
                push = torch.zeros_like(force)
            phys = run_substeps(p, phys, force, push, p.steps_per_repeat)
            if self.obs_mode == "pose_stack":
                frames.append(pose_frame(p, phys))

        steps = state.steps + 1
        x, y = phys.pos[..., 0], phys.pos[..., 1]
        sx, sy = phys.s[..., 0], phys.s[..., 1]
        done_physical, too_long = compute.termination_components(
            p, x, y, sx, sy, steps)
        tilted = sx * sx + sy * sy > p.tilt_s2_limit
        oob = done_physical & ~tilted
        done = done_physical | too_long
        reward = compute.reward_components(p, x, y, sx, sy, done_physical)

        terminal_obs = (state_obs(p, phys) if self.obs_mode == "state"
                        else stack_obs(frames))
        info = {
            "terminal_obs": terminal_obs,
            "tilted": tilted,
            "out_of_bounds": oob,
            "truncated": too_long & ~done_physical,
            "steps": steps,
        }

        if not self.auto_reset:
            return (state._replace(phys=phys, steps=steps), terminal_obs,
                    reward, done, info)
        episode = state.episode + done.to(torch.int32)
        fresh = _reset_phys(p, state.env_seed, episode)
        phys = PhysState(*(torch.where(done[:, None], f, c)
                           for f, c in zip(fresh, phys)))
        steps = torch.where(done, 0, steps)
        new_state = EnvState(phys=phys, steps=steps,
                             env_seed=state.env_seed, episode=episode)
        # The obs used to pick the NEXT action: post-reset for done envs.
        if self.obs_mode == "state":
            obs = state_obs(p, phys)
        else:
            obs = torch.where(done[:, None], self._initial_obs(phys),
                              terminal_obs)
        return new_state, obs, reward, done, info
