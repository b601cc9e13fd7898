"""Quaternion helpers for observation assembly
(cartpoleplusplus_tpu/utils/quaternion.py in torch).

Quaternions are derived branch-free from the minimal-coordinate pole
direction, in pybullet (x, y, z, w) order.
"""

from __future__ import annotations

import torch


def pole_quaternion(sx, sy, w):
    """Minimal-twist rotation taking +z to the pole direction u = (sx, sy, w):
    q_xyz = (-sy, sx, 0) / sqrt(2(1+w)), q_w = sqrt((1+w)/2)."""
    inv = 1.0 / torch.sqrt(2.0 * (1.0 + w))
    qx = -sy * inv
    qy = sx * inv
    qz = torch.zeros_like(sx)
    qw = torch.sqrt((1.0 + w) * 0.5)
    return qx, qy, qz, qw
