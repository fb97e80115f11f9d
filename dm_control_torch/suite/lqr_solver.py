"""Analytic LQR solution (reference: dm_control/suite/lqr_solver.py).

Discretizes the linear dynamics around qpos = 0, solves the discrete
algebraic Riccati equation, and returns the optimal quadratic value and
linear policy.  It runs on the host, in numpy and scipy, from one
environment's mass matrix and actuator moments.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


def solve(m, d, control_cost_coef, env=0):
    """Returns (p, k, beta): the value Hessian, the policy gain and the
    largest eigenvalue magnitude of the closed loop, for environment
    ``env`` of ``d`` (a ``Data`` after ``engine.forward``: ``qM`` and
    ``actuator_moment`` are read).  Raises RuntimeError if the controlled
    system is unstable."""
    n, nu = m.nq, m.nu
    mass = d.qM[env].detach().cpu().numpy().astype(np.float64)
    # jnt_stiffness maps onto the dofs one to one: every joint is a slide
    stiffness = np.diag(m.jnt_stiffness.detach().cpu().numpy().astype(
        np.float64))
    damping = np.diag(m.dof_damping.detach().cpu().numpy().astype(
        np.float64))
    dt = float(m.opt.timestep)

    j = np.linalg.solve(-mass, np.hstack((stiffness, damping)))
    a = np.eye(2 * n) + dt * np.vstack(
        (dt * j + np.hstack((np.zeros((n, n)), np.eye(n))), j))

    b = d.actuator_moment[env].detach().cpu().numpy().astype(np.float64).T
    bc = np.linalg.solve(mass, b)
    b = dt * np.vstack((dt * bc, bc))

    q = np.diag(np.hstack([np.ones(n), np.zeros(n)]))
    r = control_cost_coef * np.eye(nu)

    p = scipy.linalg.solve_discrete_are(a, b, q, r)
    k = -np.linalg.solve(b.T.dot(p.dot(b)) + r, b.T.dot(p.dot(a)))

    beta = np.abs(np.linalg.eigvals(a + b.dot(k))).max()
    if beta >= 1.0:
        raise RuntimeError("Controlled system is unstable.")
    return p, k, beta
