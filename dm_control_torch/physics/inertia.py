"""Composite-rigid-body inertia: the dense joint-space mass matrix and its
solve, batched.  Counterpart of ``dm_control_tpu/physics/inertia.py``."""

from __future__ import annotations

import torch

from dm_control_torch.ops import linalg
from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import Data, Model, body_subtree_mask


def crb(m: Model, d: Data) -> Data:
    """mj_crb: M[i, j] = cdof_j . (I^c_body(i) cdof_i) for j an
    ancestor-or-self of i, with I^c the subtree (composite) inertia."""
    crb_inert = body_subtree_mask(m) @ d.cinert  # (B, nbody, 10)
    f = mx.inert_mul(crb_inert[:, m.idx(m.dof_bodyid)], d.cdof)  # (B, nv, 6)
    lower = (f @ d.cdof.transpose(-1, -2)) * m.dof_ancestor_mask
    qm = lower + lower.transpose(-1, -2) - torch.diag_embed(
        torch.diagonal(lower, dim1=-2, dim2=-1))
    return d.replace(qM=qm + torch.diag(m.dof_armature))


def solve_m(m: Model, d: Data, rhs: torch.Tensor) -> torch.Tensor:
    """mj_solveM for a vector rhs (B, nv): one fused factor+solve of qM
    through ``ops.linalg.chol_solve``.

    The JAX package also factors qM into qLD once per substep
    (``factor_m``); nothing on the port's path reads qLD, and the kernel
    refactors inside the solve, so that factorization is not carried over.
    """
    return linalg.chol_solve(d.qM, rhs)


def factor_m(d: Data) -> torch.Tensor:
    """The lower Cholesky factor of qM (B, nv, nv), for ``solve_m_matrix``
    (an environment whose qM is not positive definite gets garbage in its
    own rows only)."""
    return torch.linalg.cholesky_ex(d.qM).L


def solve_m_matrix(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """mj_solveM for a matrix rhs (B, nv, k), given ``factor_m``'s factor.

    The JAX package solves its matrix right-hand sides outside its Pallas
    kernel too, with a Cholesky factor and two triangular solves
    (``dm_control_tpu/physics/inertia.py::solve_m``); this is that, as
    library calls."""
    return torch.cholesky_solve(rhs, chol)
