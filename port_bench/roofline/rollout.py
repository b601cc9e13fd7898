"""Counts shared by the rollout kernels, whose one body runs the policy
net and the env math per env-step: the env-step's float operations,
counted from the env math of csrc/cartpole_env.cuh (an add, multiply,
divide, sqrt or transcendental counts one; min, max and comparisons none),
and a rollout launch's operations and bytes."""

from __future__ import annotations

SUBSTEP_FLOP, FRICTION_FLOP, DAMPING_FLOP = 103, 10, 4
FRAME_FLOP, PUSH_FLOP, STEP_TAIL_FLOP = 24, 8, 13
# Per env: position, velocity, direction and its rate (10 floats), the
# episode's step and number (int32 each).
STATE_BYTES = 10 * 4 + 4 + 4
SEED_BYTES = 8


def env_step_flop(p: dict) -> int:
    """R repeats of S substeps, a frame and a push draw per repeat, then
    termination and reward."""
    sub = (SUBSTEP_FLOP + FRICTION_FLOP * (p["ground_friction"] != 0.0)
           + DAMPING_FLOP * ((p["linear_damping"] != 0.0)
                             + (p["angular_damping"] != 0.0)))
    rep = (p["steps_per_repeat"] * sub + FRAME_FLOP
           + PUSH_FLOP * (p["push_prob_per_repeat"] > 0.0))
    return p["action_repeats"] * rep + STEP_TAIL_FLOP


def mlp_macs(dims) -> int:
    """Multiply-adds of one row through dense layers of widths dims."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def packed_floats(obs_dim: int, hidden, n_out: int) -> int:
    """The net's floats as the rollout kernels read them: each torso weight
    with its width rounded up to 4, the head's 8 columns, then per layer
    bias and LayerNorm scale and bias, and the head's bias."""
    dims = (obs_dim,) + tuple(hidden)
    w = sum(a * ((b + 3) // 4 * 4) for a, b in zip(dims[:-1], dims[1:]))
    return w + dims[-1] * 8 + 3 * sum(hidden) + n_out


def counts(cell, n_out: int, act_bytes: int, extra_flop: int,
           carry_bytes: int) -> tuple:
    """(operations, bytes) of one launch over the cell's envs and rollout:
    the net and the env math and exploration per env-step; the state, obs,
    weights and carries read once, the trajectory, state and obs written
    once."""
    s, b = cell.settings, cell.num_envs
    f, t = cell.config["obs_dim"], s["rollout_steps"]
    macs = mlp_macs((f,) + tuple(s["hidden"]) + (n_out,))
    flop = b * t * (2 * macs + env_step_flop(cell.config["env"])
                    + extra_flop)
    nbytes = (b * (2 * STATE_BYTES + SEED_BYTES + 2 * 4 * f
                   + 2 * carry_bytes)
              + 4 * packed_floats(f, s["hidden"], n_out)
              + t * b * (4 * f + act_bytes + 4 + 1))
    return flop, nbytes


def net_flop(cell, n_out: int) -> int:
    """The policy net's forward FLOPs of one train step's rollout."""
    s = cell.settings
    dims = (cell.config["obs_dim"],) + tuple(s["hidden"]) + (n_out,)
    return cell.num_envs * s["rollout_steps"] * 2 * mlp_macs(dims)
