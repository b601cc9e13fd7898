"""Observation assembly (cartpoleplusplus_tpu/env/obs.py in torch).

A pose frame is 14 floats (cart pos3 + quat4, pole COM pos3 + quat4, in
pybullet (x, y, z, w) order); the `pose_stack` observation stacks one
frame per action repeat in lieu of velocities.
"""

from __future__ import annotations

import torch

from ..physics import CartPoleParams, PhysState
from .compute import frame_components

OBS_MODES = ("pose_stack", "state", "pixels")

FRAME_SIZE = 14  # 2 bodies x (pos3 + quat4)


def obs_size(p: CartPoleParams, mode: str) -> int:
    if mode == "pose_stack":
        return p.action_repeats * FRAME_SIZE
    if mode == "state":
        return 10
    raise ValueError(f"obs_size undefined for mode {mode!r}")


def pose_frame(p: CartPoleParams, phys: PhysState) -> torch.Tensor:
    """One 14-float pose snapshot per env: (..., 14)."""
    comps = frame_components(p, phys.pos[..., 0], phys.pos[..., 1],
                             phys.pos[..., 2], phys.s[..., 0],
                             phys.s[..., 1])
    return torch.stack(comps, dim=-1)


def stack_obs(frames) -> torch.Tensor:
    """Stack R frames on the last axis: pose frames into the flat (...,
    R*14) observation, pixel frames (..., H, W, C) on channels."""
    return torch.cat(frames, dim=-1)


def state_obs(p: CartPoleParams, phys: PhysState) -> torch.Tensor:
    """Raw minimal-coordinate observation (..., 10): pos, vel, s, sd."""
    return torch.cat([phys.pos, phys.vel, phys.s, phys.sd], dim=-1)
