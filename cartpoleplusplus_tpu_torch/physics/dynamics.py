"""Closed-form forward dynamics of the 3D cart-pole
(cartpoleplusplus_tpu/physics/dynamics.py in torch).

Reduced coordinates q = (x, y, z, ux, uy): the cart COM position and the
horizontal components s = (ux, uy) of the pole's unit direction (uz = w =
sqrt(1-|s|^2) > 0). Eliminating the diagonal cart block of the mass
matrix leaves a 2x2 Schur complement (K - J^2/Mt)(I + s s^T / w^2) whose
inverse is (I - s s^T)/(K - J^2/Mt) exactly, so one substep is ~60
branch-free flops per env. The reference module carries the derivation.

Every function works on same-shaped float32 component tensors. The
expressions are written exactly as in the reference, so Python-float
subexpressions fold in double precision at the same places; the CUDA
header csrc/cartpole_env.cuh receives those folded constants.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .params import CartPoleParams


class PhysState(NamedTuple):
    """Batched physical state. All leaves share leading batch dims.

    pos: (..., 3) cart COM (x, y, z)
    vel: (..., 3) cart velocity
    s:   (..., 2) pole direction horizontal components (ux, uy)
    sd:  (..., 2) d/dt s
    """

    pos: torch.Tensor
    vel: torch.Tensor
    s: torch.Tensor
    sd: torch.Tensor


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t rounded once, as jnp does it. `float / Tensor` in torch is
    `reciprocal(t) * float`, which rounds twice."""
    return torch.div(t.new_tensor(c), t)


def rest_state(p: CartPoleParams, batch_shape=(), device=None) -> PhysState:
    """Upright equilibrium: cart at origin resting on the ground plane."""
    z0 = p.cart_rest_z - p.rest_penetration
    pos = torch.zeros(batch_shape + (3,), dtype=torch.float32, device=device)
    pos[..., 2] = z0
    zeros = lambda n: torch.zeros(batch_shape + (n,),  # noqa: E731
                                  dtype=torch.float32, device=device)
    return PhysState(pos=pos, vel=zeros(3), s=zeros(2), sd=zeros(2))


def pole_w(p: CartPoleParams, sx, sy):
    """uz component, clamped away from the horizontal singularity."""
    return torch.sqrt(torch.clamp(1.0 - sx * sx - sy * sy,
                                  min=p.w_min * p.w_min))


def contact_normal_force(p: CartPoleParams, z, vz):
    """Penalty ground contact on the cart: stiff spring + damper, no adhesion."""
    pen = p.cart_rest_z - z
    in_contact = pen > 0.0
    f = p.contact_stiffness * pen - p.contact_damping * vz
    return torch.where(in_contact, torch.clamp(f, min=0.0), 0.0)


def generalized_forces(p: CartPoleParams, z, vx, vy, vz, sdx, sdy,
                       fx, fy, push_x, push_y):
    """Assemble Q = (Qx, Qy, Qz, Qsx, Qsy). fx, fy: actuation force on the
    cart; push_x, push_y: horizontal perturbation force on the pole COM."""
    fn = contact_normal_force(p, z, vz)
    qx = fx + push_x
    qy = fy + push_y
    # Zero-valued coefficients are gated out, as the reference does.
    if p.ground_friction != 0.0:
        qx = qx - p.ground_friction * fn * torch.tanh(vx / p.friction_vel_eps)
        qy = qy - p.ground_friction * fn * torch.tanh(vy / p.friction_vel_eps)
    if p.linear_damping != 0.0:
        qx = qx - p.linear_damping * vx
        qy = qy - p.linear_damping * vy
    qz = fn
    qsx = p.half_length * push_x
    qsy = p.half_length * push_y
    if p.angular_damping != 0.0:
        qsx = qsx - p.angular_damping * sdx
        qsy = qsy - p.angular_damping * sdy
    return qx, qy, qz, qsx, qsy


def solve_accel(p: CartPoleParams, sx, sy, sdx, sdy, qx, qy, qz, qsx, qsy):
    """Closed-form M(q)^{-1} (Q - c): returns (ax, ay, az, asx, asy)."""
    mt, jc, kg = p.total_mass, p.coupling, p.pole_gen_inertia
    mgl = p.pole_mass * p.gravity * p.half_length
    w2 = torch.clamp(1.0 - sx * sx - sy * sy, min=p.w_min * p.w_min)
    inv_w = torch.rsqrt(w2)
    inv_w2 = inv_w * inv_w
    sigma = sx * sdx + sy * sdy
    sd2 = sdx * sdx + sdy * sdy
    # Bias terms.
    curv = sd2 * inv_w2 + sigma * sigma * inv_w2 * inv_w2
    c_z = mt * p.gravity - jc * (sd2 + sigma * sigma * inv_w2) * inv_w
    c_common = kg * curv - mgl * inv_w  # c_s = c_common * s
    # Reduced RHS for the tilt block: Q_s - c_s - B^T (Q_v - c_v) / Mt.
    rv_x = qx
    rv_y = qy
    rv_z = qz - c_z
    rhs_x = qsx - c_common * sx - (jc * rv_x - jc * sx * inv_w * rv_z) / mt
    rhs_y = qsy - c_common * sy - (jc * rv_y - jc * sy * inv_w * rv_z) / mt
    # Schur inverse is (I - s s^T) / (K - J^2/Mt) exactly.
    dot = sx * rhs_x + sy * rhs_y
    inv_den = 1.0 / p.schur_denom
    asx = (rhs_x - sx * dot) * inv_den
    asy = (rhs_y - sy * dot) * inv_den
    # Back-substitute the cart accelerations.
    ax = (rv_x - jc * asx) / mt
    ay = (rv_y - jc * asy) / mt
    az = (rv_z + jc * (sx * asx + sy * asy) * inv_w) / mt
    return ax, ay, az, asx, asy


def accel_components(p: CartPoleParams, z, vx, vy, vz, sx, sy, sdx, sdy,
                     fx, fy, push_x, push_y):
    """Force assembly + solve, on raw component tensors."""
    q = generalized_forces(p, z, vx, vy, vz, sdx, sdy, fx, fy, push_x, push_y)
    return solve_accel(p, sx, sy, sdx, sdy, *q)


def substep_components(p: CartPoleParams, x, y, z, vx, vy, vz, sx, sy,
                       sdx, sdy, fx, fy, push_x, push_y):
    """One semi-implicit Euler substep on component tensors:
    v_{t+1} = v_t + dt * a(q_t, v_t);  q_{t+1} = q_t + dt * v_{t+1}."""
    ax, ay, az, asx, asy = accel_components(
        p, z, vx, vy, vz, sx, sy, sdx, sdy, fx, fy, push_x, push_y)
    dt = p.dt
    vm = p.vel_max
    # Velocity clamp: a NaN-guard far above reachable trajectories.
    vx = torch.clamp(vx + dt * ax, -vm, vm)
    vy = torch.clamp(vy + dt * ay, -vm, vm)
    vz = torch.clamp(vz + dt * az, -vm, vm)
    sdx = torch.clamp(sdx + dt * asx, -vm, vm)
    sdy = torch.clamp(sdy + dt * asy, -vm, vm)
    x = x + dt * vx
    y = y + dt * vy
    z = z + dt * vz
    sx = sx + dt * sdx
    sy = sy + dt * sdy
    # Keep s inside the chart (|s| < 1); only active far past the tilt limit.
    n = torch.sqrt(sx * sx + sy * sy)
    scale = torch.clamp(rdiv(p.s_norm_max, torch.clamp(n, min=1e-9)),
                        max=1.0)
    sx = sx * scale
    sy = sy * scale
    return x, y, z, vx, vy, vz, sx, sy, sdx, sdy


def substep(p: CartPoleParams, st: PhysState, force_xy, push_xy) -> PhysState:
    """PhysState wrapper over substep_components. force_xy/push_xy: (..., 2)."""
    x, y, z, vx, vy, vz, sx, sy, sdx, sdy = substep_components(
        p,
        st.pos[..., 0], st.pos[..., 1], st.pos[..., 2],
        st.vel[..., 0], st.vel[..., 1], st.vel[..., 2],
        st.s[..., 0], st.s[..., 1], st.sd[..., 0], st.sd[..., 1],
        force_xy[..., 0], force_xy[..., 1],
        push_xy[..., 0], push_xy[..., 1],
    )
    return PhysState(
        pos=torch.stack([x, y, z], dim=-1),
        vel=torch.stack([vx, vy, vz], dim=-1),
        s=torch.stack([sx, sy], dim=-1),
        sd=torch.stack([sdx, sdy], dim=-1),
    )


def run_substeps(p: CartPoleParams, st: PhysState, force_xy, push_xy,
                 n: int) -> PhysState:
    """n substeps with constant applied forces (one action repeat)."""
    for _ in range(n):
        st = substep(p, st, force_xy, push_xy)
    return st


def apply_push_impulse(p: CartPoleParams, st: PhysState, push_xy,
                       tau: float) -> PhysState:
    """Exact generalized impulse response to a horizontal pole push F * tau
    through the [[Mt, J], [J, K]] block per axis at the upright pose."""
    jx = push_xy[..., 0] * tau
    jy = push_xy[..., 1] * tau
    mt, jc, kg = p.total_mass, p.coupling, p.pole_gen_inertia
    l = p.half_length
    det = mt * kg - jc * jc
    # [dv; dsd] = [[Mt, J],[J, K]]^-1 [j; l j]
    dv_x = (kg * jx - jc * l * jx) / det
    dsd_x = (-jc * jx + mt * l * jx) / det
    dv_y = (kg * jy - jc * l * jy) / det
    dsd_y = (-jc * jy + mt * l * jy) / det
    vel = st.vel + torch.stack([dv_x, dv_y, torch.zeros_like(dv_x)], dim=-1)
    sd = st.sd + torch.stack([dsd_x, dsd_y], dim=-1)
    return st._replace(vel=vel, sd=sd)
