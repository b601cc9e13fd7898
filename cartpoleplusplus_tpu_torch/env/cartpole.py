"""Vectorized 3D cart-pole environment
(cartpoleplusplus_tpu/env/cartpole.py in torch, `pose_stack`, `state` and
`pixels` observations).

The batch axis is built into every tensor: one `step` advances all envs by
R action-repeats x S physics substeps, assembles the observation, and
resets finished envs in place of a per-env `reset()` (masked auto-reset).
Randomness is a pure function of (per-env seed, episode, step), with
per-env seeds derived from the global env index. Pixel observations stack
the rendered frames of the R repeat snapshots (kernel B10 on a CUDA
device, ops/render_kernel.py; its plain twin on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..physics import CartPoleParams, PhysState, rest_state, run_substeps
from ..utils.prng import as_words, hash_words
from . import compute
from .obs import OBS_MODES, obs_size, pose_frame, stack_obs, state_obs
from .pixels import RENDER_DTYPES, RenderConfig, pixel_obs_shape

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
    The device is the card unless the caller asks for another (no
    fallback: without a card, "cuda" fails in torch).

    Usage:
        env = CartPole3D(CartPoleParams(), num_envs=4096)
        env = CartPole3D(CartPoleParams(), num_envs=64, device="cpu")
        state, obs = env.reset(0)
        state, obs, reward, done, info = env.step(state, action)
    """

    def __init__(self, params: CartPoleParams = CartPoleParams(),
                 num_envs: int = 1, obs_mode: str = "pose_stack",
                 auto_reset: bool = True, device="cuda",
                 render_config: RenderConfig | None = None):
        if obs_mode not in OBS_MODES:
            raise ValueError(f"obs_mode must be one of {OBS_MODES}")
        self.params = params
        self.num_envs = num_envs
        self.obs_mode = obs_mode
        self.auto_reset = auto_reset
        self.device = torch.device(device)
        self.render_config = (render_config if render_config is not None
                              else RenderConfig())
        if self.render_config.dtype not in RENDER_DTYPES:
            raise ValueError(f"RenderConfig.dtype must be one of "
                             f"{RENDER_DTYPES}, got "
                             f"{self.render_config.dtype!r}")
        self._reset_obs = None  # the constant pixel reset obs, made once

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
        """Flat observation length (pixels: product of obs_shape)."""
        if self.obs_mode == "pixels":
            h, w, c = self.obs_shape
            return h * w * c
        return obs_size(self.params, self.obs_mode)

    @property
    def obs_shape(self) -> tuple:
        """Per-env observation shape: (obs_size,) or (H, W, C) for pixels
        (repeat frames and cameras stacked on channels)."""
        if self.obs_mode == "pixels":
            return pixel_obs_shape(self.params, self.render_config)
        return (obs_size(self.params, self.obs_mode),)

    def render(self, phys: PhysState) -> torch.Tensor:
        """Every camera's view of `phys` (any batch): (N, H, W, C *
        num_cameras) float32 in [0, 1], through kernel B10 (B11 under
        CARTPOLE_RENDER_CULL=1) on a CUDA device and its twin on the
        CPU."""
        from ..ops.render_kernel import render

        return render(self.params, self.render_config, phys)

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

    def _quantize(self, frame):
        """Float frames -> uint8 when RenderConfig.obs_uint8 (truncation
        of x * 255 + 0.5, clipped to [0, 255])."""
        if self.render_config.obs_uint8:
            return torch.clamp(frame * 255.0 + 0.5, 0.0, 255.0).to(
                torch.uint8)
        return frame

    def _pixel_obs(self, frames) -> torch.Tensor:
        """The pixel observation of R float frames: the frames stacked on
        channels, or with RenderConfig.frame_diff [latest frame, clip(0.5
        gain (f_r - f_{r-1}) + 0.5) per consecutive pair], the diffs taken
        on the float frames; quantized afterwards when configured."""
        if self.render_config.frame_diff:
            g = 0.5 * self.render_config.frame_diff_gain
            frames = [frames[-1]] + [torch.clamp(g * (b - a) + 0.5, 0.0, 1.0)
                                     for a, b in zip(frames[:-1], frames[1:])]
        return stack_obs([self._quantize(f) for f in frames])

    def _reset_obs_pixels(self) -> torch.Tensor:
        """(1, H, W, C*R): the observation of every freshly reset env. The
        reset pose is deterministic (reset randomness enters through the
        velocities, and a frame reads only pos and s), so it is one
        constant image, rendered once (one render at batch 1) and kept."""
        if self._reset_obs is None:
            frame = self.render(rest_state(self.params, batch_shape=(1,),
                                           device=self.device))
            self._reset_obs = self._pixel_obs(
                [frame] * self.params.action_repeats)
        return self._reset_obs

    def _initial_obs(self, phys: PhysState) -> torch.Tensor:
        if self.obs_mode == "state":
            return state_obs(self.params, phys)
        # A fresh episode's observation repeats the initial pose (or
        # frame) across the repeat window.
        if self.obs_mode == "pixels":
            return self._pixel_obs([self.render(phys)]
                                   * self.params.action_repeats)
        frame = pose_frame(self.params, phys)
        return stack_obs([frame] * self.params.action_repeats)

    def step(self, state: EnvState, action):
        """One env-step: R action-repeats x S physics substeps, pose
        snapshot per repeat, termination, reward, masked auto-reset."""
        p = self.params
        force = _map_action(p, action)
        phys = state.phys

        frames, snaps = [], []
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
            snaps.append(phys)
        if self.obs_mode == "pixels":
            # One render of all R snapshots, stacked as R x B virtual envs.
            b = self.num_envs
            stacked = self.render(PhysState(*(torch.cat(xs)
                                              for xs in zip(*snaps))))
            frames = [stacked[r * b:(r + 1) * b]
                      for r in range(p.action_repeats)]

        steps = state.steps + 1
        x, y = phys.pos[..., 0], phys.pos[..., 1]
        sx, sy = phys.s[..., 0], phys.s[..., 1]
        done_physical, too_long = compute.termination_components(
            p, x, y, sx, sy, steps)
        tilted = sx * sx + sy * sy > p.tilt_s2_limit
        oob = done_physical & ~tilted
        done = done_physical | too_long
        reward = compute.reward_components(p, x, y, sx, sy, done_physical)

        if self.obs_mode == "state":
            terminal_obs = state_obs(p, phys)
        elif self.obs_mode == "pixels":
            terminal_obs = self._pixel_obs(frames)
        else:
            terminal_obs = stack_obs(frames)
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
            reset_obs = (self._reset_obs_pixels() if self.obs_mode == "pixels"
                         else self._initial_obs(phys))
            done_b = done.reshape(done.shape + (1,) * (reset_obs.ndim - 1))
            obs = torch.where(done_b, reset_obs, terminal_obs)
        return new_state, obs, reward, done, info
