"""The batched 3D cart-pole in plain PyTorch: closed-form dynamics, resets
with the initial push impulse, mid-episode pushes, the pose-stack
observation, termination, reward and masked auto-reset.

The parameters are the `env` object of a configuration file under
`port_bench/configs/`. Python-float subexpressions fold in double precision
before they touch a float32 tensor, as the cells' programs fold them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .prng import hash_words, normal, uniform

TAG_RESET_ANGLE = 0x11
TAG_RESET_MAG = 0x12
TAG_PUSH_GATE = 0x21
TAG_PUSH_ANGLE = 0x22
TAG_PUSH_MAG = 0x23
TAG_OU_X = 0x41
TAG_OU_Y = 0x42
TAG_EPS_GATE = 0x43
TAG_EPS_ACT = 0x44
NUM_ACTIONS = 5
_ACTION_TABLE = ((0.0, 0.0), (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0),
                 (0.0, -1.0))


@dataclasses.dataclass(frozen=True)
class EnvParams:
    cart_mass: float = 1.0
    pole_mass: float = 0.1
    pole_length: float = 1.0
    gravity: float = 9.81
    pivot_height: float = 0.1
    cart_rest_z: float = 0.1
    contact_stiffness: float = 5000.0
    contact_damping: float = 140.0
    ground_friction: float = 0.0
    friction_vel_eps: float = 0.05
    linear_damping: float = 0.0
    angular_damping: float = 0.0
    dt: float = 1.0 / 240.0
    steps_per_repeat: int = 5
    action_repeats: int = 3
    action_force: float = 12.0
    discrete_actions: bool = True
    initial_push_force: float = 1.2
    initial_push_duration: float = 5.0 / 240.0
    push_prob_per_repeat: float = 0.0
    push_force: float = 1.2
    tilt_limit: float = 0.3
    pos_limit: float = 2.4
    max_episode_steps: int = 200
    reward_shaped: bool = False
    w_min: float = 0.05
    s_norm_max: float = 0.995
    vel_max: float = 100.0

    @property
    def half_length(self):
        return 0.5 * self.pole_length

    @property
    def total_mass(self):
        return self.cart_mass + self.pole_mass

    @property
    def coupling(self):
        return self.pole_mass * self.half_length

    @property
    def pole_gen_inertia(self):
        return (self.pole_mass * self.half_length ** 2
                + self.pole_mass * self.pole_length ** 2 / 12.0)

    @property
    def schur_denom(self):
        return self.pole_gen_inertia - self.coupling ** 2 / self.total_mass

    @property
    def rest_penetration(self):
        return self.total_mass * self.gravity / self.contact_stiffness

    @property
    def tilt_s2_limit(self):
        return math.sin(self.tilt_limit) ** 2


class Env(NamedTuple):
    """Per-env state, batch first: cart position, velocity, pole direction
    (sx, sy) and its rate, each as a tuple of (B,) components."""

    q: tuple               # x, y, z, vx, vy, vz, sx, sy, sdx, sdy
    steps: torch.Tensor    # (B,) int32, steps in the current episode
    env_seed: torch.Tensor  # (B,) int64 words
    episode: torch.Tensor  # (B,) int32


def _reset_q(p: EnvParams, env_seed, episode):
    ang = uniform(0.0, 2.0 * math.pi, env_seed, episode, TAG_RESET_ANGLE)
    mag = uniform(0.2, 1.0, env_seed, episode, TAG_RESET_MAG) \
        * p.initial_push_force
    px, py = mag * torch.cos(ang), mag * torch.sin(ang)
    tau = p.initial_push_duration
    jx, jy = px * tau, py * tau
    mt, jc, kg, l = p.total_mass, p.coupling, p.pole_gen_inertia, \
        p.half_length
    det = mt * kg - jc * jc
    zero = torch.zeros_like(jx)
    z0 = torch.full_like(jx, p.cart_rest_z - p.rest_penetration)
    return (zero, zero, z0, (kg - jc * l) * jx / det, (kg - jc * l) * jy
            / det, zero, zero, zero, (mt * l - jc) * jx / det,
            (mt * l - jc) * jy / det)


def _rdiv(c: float, t):
    return torch.div(t.new_tensor(c), t)


def _substep(p: EnvParams, q, fx, fy, push_x, push_y):
    x, y, z, vx, vy, vz, sx, sy, sdx, sdy = q
    pen = p.cart_rest_z - z
    f = p.contact_stiffness * pen - p.contact_damping * vz
    fn = torch.where(pen > 0.0, torch.clamp(f, min=0.0), 0.0)
    qx, qy = fx + push_x, fy + push_y
    if p.ground_friction != 0.0:
        qx = qx - p.ground_friction * fn * torch.tanh(vx / p.friction_vel_eps)
        qy = qy - p.ground_friction * fn * torch.tanh(vy / p.friction_vel_eps)
    if p.linear_damping != 0.0:
        qx = qx - p.linear_damping * vx
        qy = qy - p.linear_damping * vy
    qz = fn
    qsx, qsy = p.half_length * push_x, p.half_length * push_y
    if p.angular_damping != 0.0:
        qsx = qsx - p.angular_damping * sdx
        qsy = qsy - p.angular_damping * sdy
    mt, jc, kg = p.total_mass, p.coupling, p.pole_gen_inertia
    mgl = p.pole_mass * p.gravity * p.half_length
    w2 = torch.clamp(1.0 - sx * sx - sy * sy, min=p.w_min * p.w_min)
    inv_w = torch.rsqrt(w2)
    inv_w2 = inv_w * inv_w
    sigma = sx * sdx + sy * sdy
    sd2 = sdx * sdx + sdy * sdy
    curv = sd2 * inv_w2 + sigma * sigma * inv_w2 * inv_w2
    c_z = mt * p.gravity - jc * (sd2 + sigma * sigma * inv_w2) * inv_w
    c_common = kg * curv - mgl * inv_w
    rv_z = qz - c_z
    rhs_x = qsx - c_common * sx - (jc * qx - jc * sx * inv_w * rv_z) / mt
    rhs_y = qsy - c_common * sy - (jc * qy - jc * sy * inv_w * rv_z) / mt
    dot = sx * rhs_x + sy * rhs_y
    inv_den = 1.0 / p.schur_denom
    asx = (rhs_x - sx * dot) * inv_den
    asy = (rhs_y - sy * dot) * inv_den
    ax = (qx - jc * asx) / mt
    ay = (qy - jc * asy) / mt
    az = (rv_z + jc * (sx * asx + sy * asy) * inv_w) / mt
    dt, vm = p.dt, p.vel_max
    vx = torch.clamp(vx + dt * ax, -vm, vm)
    vy = torch.clamp(vy + dt * ay, -vm, vm)
    vz = torch.clamp(vz + dt * az, -vm, vm)
    sdx = torch.clamp(sdx + dt * asx, -vm, vm)
    sdy = torch.clamp(sdy + dt * asy, -vm, vm)
    x, y, z = x + dt * vx, y + dt * vy, z + dt * vz
    sx, sy = sx + dt * sdx, sy + dt * sdy
    n = torch.sqrt(sx * sx + sy * sy)
    scale = torch.clamp(_rdiv(p.s_norm_max, torch.clamp(n, min=1e-9)),
                        max=1.0)
    return x, y, z, vx, vy, vz, sx * scale, sy * scale, sdx, sdy


def _frame(p: EnvParams, q):
    """The 14-float pose snapshot: cart position and identity quaternion,
    pole COM position and quaternion, (x, y, z, w) order."""
    x, y, z, sx, sy = q[0], q[1], q[2], q[6], q[7]
    w = torch.sqrt(torch.clamp(1.0 - sx * sx - sy * sy,
                               min=p.w_min * p.w_min))
    inv = 1.0 / torch.sqrt(2.0 * (1.0 + w))
    zero, one = torch.zeros_like(sx), torch.ones_like(sx)
    l = p.half_length
    return torch.stack((x, y, z, zero, zero, zero, one, x + l * sx,
                        y + l * sy, z + p.pivot_height + l * w, -sy * inv,
                        sx * inv, zero, torch.sqrt((1.0 + w) * 0.5)), -1)


def reset(p: EnvParams, seed: int, num_envs: int, device):
    """Every env's first episode, seeded from (seed, env index)."""
    idx = torch.arange(num_envs, dtype=torch.int64, device=device)
    env_seed = hash_words(seed & 0xFFFFFFFF, idx)
    episode = torch.zeros(num_envs, dtype=torch.int32, device=device)
    q = _reset_q(p, env_seed, episode)
    st = Env(q, torch.zeros_like(episode), env_seed, episode)
    return st, torch.cat([_frame(p, q)] * p.action_repeats, -1)


def step(p: EnvParams, st: Env, action):
    """One env-step of every env: action repeats of substeps, a pose frame
    per repeat, termination, reward, then a fresh episode where one ended.
    Returns (state', next obs, reward, done)."""
    if p.discrete_actions:
        table = torch.tensor(_ACTION_TABLE, dtype=torch.float32,
                             device=action.device)
        force = table[action.long()] * p.action_force
    else:
        force = torch.clamp(action, -1.0, 1.0) * p.action_force
    fx, fy = force[:, 0], force[:, 1]
    q, frames = st.q, []
    for r in range(p.action_repeats):
        if p.push_prob_per_repeat > 0.0:
            words = (st.env_seed, st.episode, st.steps, r)
            gate = uniform(0.0, 1.0, *words, TAG_PUSH_GATE)
            ang = uniform(0.0, 2.0 * math.pi, *words, TAG_PUSH_ANGLE)
            mag = uniform(0.0, 1.0, *words, TAG_PUSH_MAG) * p.push_force
            on = torch.where(gate < p.push_prob_per_repeat, 1.0, 0.0)
            px, py = on * mag * torch.cos(ang), on * mag * torch.sin(ang)
        else:
            px = py = torch.zeros_like(fx)
        for _ in range(p.steps_per_repeat):
            q = _substep(p, q, fx, fy, px, py)
        frames.append(_frame(p, q))
    steps = st.steps + 1
    x, y, sx, sy = q[0], q[1], q[6], q[7]
    s2 = sx * sx + sy * sy
    done_phys = ((s2 > p.tilt_s2_limit) | (torch.abs(x) > p.pos_limit)
                 | (torch.abs(y) > p.pos_limit))
    done = done_phys | (steps >= p.max_episode_steps)
    if p.reward_shaped:
        d2 = x * x + y * y
        shaped = (1.0 - 0.5 * s2 / p.tilt_s2_limit
                  - 0.5 * d2 / (p.pos_limit * p.pos_limit))
        reward = torch.where(done_phys, 0.0, torch.clamp(shaped, min=0.0))
    else:
        reward = torch.where(done_phys, 0.0, 1.0)
    episode = st.episode + done.to(torch.int32)
    fresh = _reset_q(p, st.env_seed, episode)
    q = tuple(torch.where(done, f, c) for f, c in zip(fresh, q))
    obs = torch.where(done[:, None],
                      torch.cat([_frame(p, q)] * p.action_repeats, -1),
                      torch.cat(frames, -1))
    return (Env(q, torch.where(done, 0, steps), st.env_seed, episode), obs,
            reward, done)


def ou_noise(noise, env_seed, t: int, theta: float, sigma: float):
    """One Ornstein-Uhlenbeck update with counter normals at step t."""
    eps = torch.stack([normal(env_seed, t, TAG_OU_X),
                       normal(env_seed, t, TAG_OU_Y)], -1)
    return noise + theta * (0.0 - noise) + sigma * eps


def epsilon_greedy(q_values, env_seed, t: int, eps: float):
    """The counter-random action where the gate draw is below eps, else
    the first-max argmax."""
    greedy = torch.argmax(q_values, -1).to(torch.int32)
    rand = (hash_words(env_seed, t, TAG_EPS_ACT) % NUM_ACTIONS).to(
        torch.int32)
    explore = uniform(0.0, 1.0, env_seed, t, TAG_EPS_GATE) < eps
    return torch.where(explore, rand, greedy)
