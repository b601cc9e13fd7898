"""Autodiff-Lagrangian forward dynamics: an independent ground truth
(cartpoleplusplus_tpu/physics/lagrangian.py on torch.func).

The cart-pole's equations of motion re-derived mechanically from the
Lagrangian by automatic differentiation (`torch.func.hessian`, `grad` and
`jacfwd`), with no hand-derived algebra, to check the closed-form solver
of physics/dynamics.py (tests/test_torch_tools.py holds the two and the
reference's autodiff solver to one another on seeded states).

Not a hot path: tests only (a dense 5 x 5 solve per state, the mass
matrix through a Hessian).
"""

from __future__ import annotations

import torch
from torch.func import grad, hessian, jacfwd

from .params import CartPoleParams


def lagrangian(p: CartPoleParams, q: torch.Tensor,
               qd: torch.Tensor) -> torch.Tensor:
    """L(q, qd) for q = (x, y, z, ux, uy): conservative terms only.

    Contact, friction and actuation enter as generalized forces Q, as in
    the closed-form solver.
    """
    z = q[2]
    s = q[3:5]
    v = qd[0:3]
    sd = qd[3:5]
    w = torch.sqrt(1.0 - torch.sum(s * s))
    udz = -torch.dot(s, sd) / w
    u3 = torch.cat([sd, udz[None]])
    mt, jc, kg = p.total_mass, p.coupling, p.pole_gen_inertia
    t = (0.5 * mt * torch.dot(v, v) + jc * torch.dot(v, u3)
         + 0.5 * kg * torch.dot(u3, u3))
    vpot = mt * p.gravity * z + p.pole_mass * p.gravity * p.half_length * w
    return t - vpot


def solve_accel_autodiff(p: CartPoleParams, q: torch.Tensor,
                         qd: torch.Tensor,
                         gen_force: torch.Tensor) -> torch.Tensor:
    """qdd from M(q) qdd = Q + dL/dq - (d2L/dq dqd) qd, all by autodiff."""
    def lag(q_, qd_):
        return lagrangian(p, q_, qd_)

    mass = hessian(lag, argnums=1)(q, qd)
    dl_dq = grad(lag, argnums=0)(q, qd)
    # Coriolis/centrifugal: the part of d/dt(dL/dqd) from q moving.
    mixed = jacfwd(grad(lag, argnums=1), argnums=0)(q, qd)
    rhs = gen_force + dl_dq - mixed @ qd
    return torch.linalg.solve(mass, rhs)
