"""Newton constraint solver (mj_solNewton) for pyramidal cones, batched.

Counterpart of ``dm_control_tpu/physics/solver.py``.  Minimizes over qacc

    c(x) = 0.5 (x - a_s)^T M (x - a_s) + sum_i s_i(J_i x - aref_i)

with s_i = 0.5 D_i jar_i^2 on every equality row, and on a unilateral row
(limits and pyramidal contacts) where jar_i < 0.  Each Newton step solves
with the exact Hessian M + J^T diag(D active) J through
``ops.linalg.chol_solve`` and takes an exact line search on the
piecewise-quadratic 1D restriction.

JAX's batched ``while_loop`` becomes a host loop over a batch mask: every
iteration computes the step for the whole batch, and an environment whose
stopping test already held keeps its state, so each environment's result
is the one its own unbatched solve gives.  The loop ends when no
environment is active (one ``.any()`` on the host per iteration).
"""

from __future__ import annotations

import torch

from dm_control_torch.ops import linalg
from dm_control_torch.physics.constraints import Efc
from dm_control_torch.physics.model import Data, DisableBit, Model

_MINVAL = 1e-15


def _bmv(mat, vec):
    return torch.einsum("bij,bj->bi", mat, vec)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def solve(m: Model, d: Data, efc: Efc) -> Data:
    dtype = d.qpos.dtype
    a_s = d.qacc_smooth
    M = d.qM
    J, D = efc.J, efc.D

    # equality rows (the first efc.ne) are quadratic everywhere
    is_eq = m.cached(("efc_is_eq", efc.nefc, efc.ne), lambda: torch.arange(
        efc.nefc, device=m.device) < efc.ne) if efc.ne else None

    def cost_terms(jar):
        quad = jar < 0
        if is_eq is not None:
            quad = quad | is_eq
        zero = torch.zeros_like(jar)
        return (torch.where(quad, 0.5 * D * jar * jar, zero),
                torch.where(quad, D * jar, zero), torch.where(quad, D, zero))

    def cost_from_jar(x, jar):
        dx = x - a_s
        return 0.5 * _dot(dx, _bmv(M, dx)) + torch.sum(cost_terms(jar)[0], -1)

    def total_cost(x):
        jar = _bmv(J, x) - efc.aref
        return cost_from_jar(x, jar), jar

    c0, jar_s = total_cost(a_s)
    if not (m.opt.disableflags & DisableBit.WARMSTART):
        cw, jar_w = total_cost(d.qacc_warmstart)
        take_w = cw < c0
        x = torch.where(take_w.unsqueeze(-1), d.qacc_warmstart, a_s)
        jar = torch.where(take_w.unsqueeze(-1), jar_w, jar_s)
        cost = torch.minimum(cw, c0)
    else:
        x, jar, cost = a_s, jar_s, c0

    thresh = m.opt.tolerance * (m.stat.meaninertia * max(1, m.nv))
    # Line-search depth by dtype: 25 bisection/Newton rounds in float64
    # (the parity path), 12 in float32, as the JAX package.
    if dtype == torch.float64:
        nls = max(min(m.opt.ls_iterations, 25), 12)
    else:
        nls = max(min(m.opt.ls_iterations, 12), 8)
    ngrow = 10

    B = x.shape[0]
    inf = torch.full((B,), float("inf"), dtype=dtype, device=x.device)
    improvement, gnorm = inf, inf
    niter = torch.zeros(B, dtype=torch.int32, device=x.device)
    while True:
        active = ((niter < m.opt.iterations) & (improvement > thresh)
                  & (gnorm > thresh))
        if not bool(active.any()):
            break
        _, dcost, hw = cost_terms(jar)
        grad = _bmv(M, x - a_s) + torch.einsum("bkv,bk->bv", J, dcost)
        H = M + torch.bmm(J.transpose(1, 2) * hw.unsqueeze(1), J)
        p = -linalg.chol_solve(H, grad)

        jp = _bmv(J, p)
        mp = _bmv(M, p)
        p_mp = _dot(p, mp)
        x_as = x - a_s

        def phi_derivs(alpha):
            _, dcost_a, hw_a = cost_terms(jar + alpha.unsqueeze(-1) * jp)
            d1 = _dot(x_as + alpha.unsqueeze(-1) * p, mp) \
                + torch.sum(dcost_a * jp, -1)
            d2 = p_mp + torch.sum(hw_a * jp * jp, -1)
            return d1, d2

        # bracket the root of phi' by doubling from alpha = 1 ...
        one = torch.ones_like(improvement)
        d1_1, _ = phi_derivs(one)
        hi, d1_hi = one, d1_1
        for _ in range(ngrow):
            take = d1_hi < 0
            hi2 = torch.where(take, hi * 2.0, hi)
            d1_hi2, _ = phi_derivs(hi2)
            hi = torch.where(take, hi2, hi)
            d1_hi = torch.where(take, d1_hi2, d1_hi)
        lo = torch.where(d1_1 < 0, hi * 0.5, torch.zeros_like(hi))
        # ... then Newton steps safeguarded by bisection
        alpha = 0.5 * (lo + hi)
        for _ in range(nls):
            d1, d2 = phi_derivs(alpha)
            lo = torch.where(d1 < 0, alpha, lo)
            hi = torch.where(d1 > 0, alpha, hi)
            newton = alpha - d1 / torch.clamp(d2, min=_MINVAL)
            inside = (newton >= lo) & (newton <= hi)
            nxt = torch.where(inside, newton, 0.5 * (lo + hi))
            alpha = torch.where(d1 == 0, alpha, nxt)

        x_new = x + alpha.unsqueeze(-1) * p
        jar_new = jar + alpha.unsqueeze(-1) * jp
        cost_new = cost_from_jar(x_new, jar_new)
        better = (cost_new < cost).unsqueeze(-1)
        x_new = torch.where(better, x_new, x)
        jar_new = torch.where(better, jar_new, jar)
        cost_new = torch.minimum(cost_new, cost)

        a1 = active.unsqueeze(-1)
        x = torch.where(a1, x_new, x)
        jar = torch.where(a1, jar_new, jar)
        improvement = torch.where(active, cost - cost_new, improvement)
        gnorm = torch.where(active, torch.linalg.vector_norm(grad, dim=-1),
                            gnorm)
        cost = torch.where(active, cost_new, cost)
        niter = niter + active.to(torch.int32)

    jar = _bmv(J, x) - efc.aref
    efc_force = -cost_terms(jar)[1]
    qfrc_constraint = torch.einsum("bkv,bk->bv", J, efc_force)

    # per-contact force (mj_contactForce): pyramidal rows are
    # n +- mu_i t_i, so normal = sum_j f_j, comp_i = mu_i (f_2i - f_2i+1)
    contact_force = torch.zeros_like(d.contact.dist)
    contact_force_vec = contact_force.new_zeros(*contact_force.shape, 6)
    for conids, start, nrows in efc.contact_spans:
        k = len(conids)
        ids = m.idx(conids)
        group = efc_force[:, start:start + k * nrows].reshape(B, k, nrows)
        normal = group.sum(-1)
        contact_force[:, ids] = normal
        wrench = torch.zeros(B, k, 6, dtype=dtype, device=x.device)
        wrench[..., 0] = normal
        if nrows > 1:
            nfd = nrows // 2
            mu = d.contact.friction[:, ids, :nfd]
            wrench[..., 1:1 + nfd] = mu * (group[..., 0::2] - group[..., 1::2])
        contact_force_vec[:, ids] = wrench
    return d.replace(qacc=x, qfrc_constraint=qfrc_constraint,
                     contact_force=contact_force,
                     contact_force_vec=contact_force_vec, solver_niter=niter)
