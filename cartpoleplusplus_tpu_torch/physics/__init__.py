from .params import CartPoleParams, continuous_params
from .dynamics import (
    PhysState,
    accel_components,
    apply_push_impulse,
    contact_normal_force,
    generalized_forces,
    pole_w,
    rest_state,
    run_substeps,
    solve_accel,
    substep,
    substep_components,
)

__all__ = [
    "CartPoleParams",
    "continuous_params",
    "PhysState",
    "accel_components",
    "apply_push_impulse",
    "contact_normal_force",
    "generalized_forces",
    "pole_w",
    "rest_state",
    "run_substeps",
    "solve_accel",
    "substep",
    "substep_components",
]
