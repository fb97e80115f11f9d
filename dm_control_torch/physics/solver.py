"""Newton constraint solver (mj_solNewton), batched.

Counterpart of ``dm_control_tpu/physics/solver.py``.  Minimizes over qacc

    c(x) = 0.5 (x - a_s)^T M (x - a_s) + sum_i s_i(J_i x - aref_i)

with, per row kind: s_i = 0.5 D_i jar_i^2 on every equality row, and on a
unilateral row (limits and pyramidal contacts) where jar_i < 0; a Huber
cost on a friction-loss row (quadratic where |D jar| <= floss, linear
outside); and the cost of each elliptic cone on its contact's rows
(``_cone_eval``).  Each Newton step solves with the exact Hessian
M + J^T diag(D active) J + the cones' blocks through
``ops.linalg.chol_solve`` and takes an exact line search on the piecewise
smooth 1D restriction.

JAX's batched ``while_loop`` becomes a host loop over a batch mask: every
iteration computes the step for the whole batch, and an environment whose
stopping test already held keeps its state, so each environment's result
is the one its own unbatched solve gives.  The loop ends when no
environment is active (one ``.any()`` on the host per iteration).
"""

from __future__ import annotations

import torch

from dm_control_torch.ops import linalg
from dm_control_torch.physics import inertia as inr
from dm_control_torch.physics.constraints import Efc
from dm_control_torch.physics.model import Data, DisableBit, Model

_MINVAL = 1e-15


def _bmv(mat, vec):
    return torch.einsum("bij,bj->bi", mat, vec)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _row_masks(m: Model, efc: Efc):
    """(equality, friction loss, unilateral) row masks (nefc,), each None
    where no row has that kind; the unilateral one also None where every
    row that is not an equality is unilateral."""
    def build():
        rows = torch.arange(efc.nefc, device=m.device)
        first_cone = efc.nefc - efc.ncone
        eq = rows < efc.ne if efc.ne else None
        fl = ((rows >= efc.ne) & (rows < efc.ne + efc.nf)) if efc.nf \
            else None
        uni = ((rows >= efc.ne + efc.nf) & (rows < first_cone)) \
            if efc.nf or efc.ncone else None
        return eq, fl, uni

    return m.cached(("efc_masks", efc.nefc, efc.ne, efc.nf, efc.ncone), build)


def _cost_terms(D, jar, masks, fl=None):
    """Cost, gradient and Hessian weight (B, nefc) of each row that is not
    a cone's (those get 0): quadratic on equality rows and on active
    unilateral rows; on a friction-loss row the Huber cost, linear where
    |D jar| > floss.  ``masks`` are ``_row_masks``; ``fl`` is (floss,
    0.5 floss^2 / D), each (nefc,), where the model has friction loss."""
    is_eq, is_fl, is_uni = masks
    quad = jar < 0
    if is_uni is not None:
        quad = quad & is_uni
    if is_eq is not None:
        quad = quad | is_eq
    zero = torch.zeros_like(jar)
    if fl is None:
        return (torch.where(quad, 0.5 * D * jar * jar, zero),
                torch.where(quad, D * jar, zero), torch.where(quad, D, zero))
    floss, half_fl2 = fl
    djar = D * jar
    lin_hi = is_fl & (djar > floss)
    lin_lo = is_fl & (djar < -floss)
    quad = quad | (is_fl & ~lin_hi & ~lin_lo)
    cost = torch.where(quad, 0.5 * D * jar * jar, zero)
    cost = torch.where(lin_hi, floss * jar - half_fl2, cost)
    cost = torch.where(lin_lo, -floss * jar - half_fl2, cost)
    dcost = torch.where(quad, djar, zero)
    dcost = torch.where(lin_hi, floss, dcost)
    dcost = torch.where(lin_lo, -floss, dcost)
    return cost, dcost, torch.where(quad, D, zero)


def _cone_groups(m: Model, d: Data, efc: Efc):
    """Per elliptic span: (first row, k, condim, friction (B, k, condim-1),
    mu (B, k), D (B, k, condim)); the spans are the last rows, in order."""
    groups = []
    row = efc.nefc - efc.ncone
    B = efc.D.shape[0]
    for conids, start, dim in efc.cone_spans:
        assert start == row, "elliptic rows must close the row order"
        k = len(conids)
        fri = d.contact.friction[:, m.idx(conids), :dim - 1]
        mu = fri[..., 0] / torch.sqrt(m.opt.impratio)
        Dg = efc.D[:, start:start + k * dim].reshape(B, k, dim)
        groups.append((start, k, dim, fri, mu, Dg))
        row += k * dim
    return groups


def _cone_eval(groups, jar, jp=None, hess=False):
    """The elliptic cones at ``jar`` (B, nefc): cost (B,), the cone rows'
    cost gradients (B, ncone), and with ``hess`` the per-contact Hessian
    blocks [(B, k, c, c)]; with ``jp``, the curvature jp^T H jp (B,) along
    a direction's row values ``jp`` in place of the cost (the line search
    needs no cost).

    With n = jar_0, u_j = mu_j jar_j, t = |u|, mu = mu_0 / sqrt(impratio):
    separating (n >= t): no cost; sticking (mu^2 n + t <= 0): each row
    quadratic, 0.5 D_j jar_j^2; sliding (otherwise): 0.5 D_0 / (1 + mu^2)
    (n - t)^2, the force on the cone's surface."""
    B = jar.shape[0]
    cost = jar.new_zeros(B) if jp is None else None
    dparts, hparts = [], []
    curv = jar.new_zeros(B) if jp is not None else None
    for start, k, dim, fri, mu, Dg in groups:
        jar_g = jar[:, start:start + k * dim].reshape(B, k, dim)
        D0 = Dg[..., 0]
        n = jar_g[..., 0]
        u = fri * jar_g[..., 1:]
        tt = torch.sqrt(torch.sum(u * u, -1))
        tts = torch.clamp(tt, min=_MINVAL)
        active = D0 > 0
        bottom = (mu * mu * n + tt <= 0) & active
        top = n >= tt
        mid = active & ~bottom & ~top
        dm = D0 / (1.0 + mu * mu)
        nmt = n - tt
        zero = torch.zeros_like(n)
        if jp is None:
            c_bot = 0.5 * torch.sum(Dg * jar_g * jar_g, -1)
            c_mid = 0.5 * dm * nmt * nmt
            cost = cost + torch.sum(torch.where(
                bottom, c_bot, torch.where(mid, c_mid, zero)), -1)
        w = fri * u / tts.unsqueeze(-1)  # fri_j^2 jar_j / t
        g = torch.cat([torch.ones_like(n).unsqueeze(-1), -w], -1)
        d_mid = (dm * nmt).unsqueeze(-1) * g
        d_bot = Dg * jar_g
        b3, m3 = bottom.unsqueeze(-1), mid.unsqueeze(-1)
        dg = torch.where(b3, d_bot, torch.where(m3, d_mid,
                                                torch.zeros_like(d_mid)))
        dparts.append(dg.reshape(B, k * dim))
        if not hess and jp is None:
            continue
        # the sliding zone's curvature coefficient on the tangent block
        coef = dm * (tt - n) / tts
        if hess:
            eye_t = torch.eye(dim - 1, dtype=jar.dtype, device=jar.device)
            tang = (fri.unsqueeze(-1) * fri.unsqueeze(-2) * eye_t
                    - w.unsqueeze(-1) * w.unsqueeze(-2))
            h_mid = dm[..., None, None] * g.unsqueeze(-1) * g.unsqueeze(-2)
            h_mid[..., 1:, 1:] += coef[..., None, None] * tang
            h_bot = torch.diag_embed(Dg)
            hparts.append(torch.where(b3.unsqueeze(-1), h_bot, torch.where(
                m3.unsqueeze(-1), h_mid, torch.zeros_like(h_mid))))
        if jp is not None:
            jp_g = jp[:, start:start + k * dim].reshape(B, k, dim)
            jp_t = jp_g[..., 1:]
            q_mid = dm * _dot(g, jp_g) ** 2 + coef * (
                _dot(fri * fri, jp_t * jp_t) - _dot(w, jp_t) ** 2)
            q_bot = _dot(Dg, jp_g * jp_g)
            curv = curv + torch.sum(torch.where(
                bottom, q_bot, torch.where(mid, q_mid, zero)), -1)
    return cost, torch.cat(dparts, dim=1), hparts, curv


def _noslip_order(force, start, k, nrows, gather):
    """The contacts (B, K) of one pyramidal span that the sweep visits, in
    order.  With ``gather``: first each environment's contacts with a
    nonzero row force, in their order, then its others, cut at the
    batch's largest count K of the first kind; without: every contact."""
    B = force.shape[0]
    if not gather:
        return torch.arange(k, device=force.device).expand(B, k)
    live = (force[:, start:start + k * nrows].reshape(B, k, nrows)
            != 0).any(-1)
    K = int(live.sum(-1).max())
    return torch.sort((~live).to(torch.uint8), dim=1,
                      stable=True).indices[:, :K]


def noslip(m: Model, d: Data, efc: Efc, qacc, force, gather=True):
    """The noslip post-pass (mj_noSlip): ``opt.noslip_iterations``
    Gauss-Seidel sweeps over the friction variables of the unregularized
    dual (A = J M^-1 J^T, residual J qacc - aref), each sweep first over
    the friction-loss rows, one after another, each clamped to
    [-floss, floss]; then over the pyramidal contacts, span by span and
    contact by contact, each contact's pairs one after another: the pair
    sum mid_j = (f_2j + f_2j+1) / 2 stays fixed and the half difference
    y_j takes a 1-D Newton step clamped to |y_j| <= mid_j.  Returns
    (force, qacc).  Counterpart of
    ``dm_control_tpu/physics/solver.py::_noslip``.

    Why only some contacts are visited (``gather``): the Newton solution's
    pyramid forces are >= 0, so a contact whose rows all carry zero force
    has mid_j = 0 for every pair.  Its update is then y_j = 0, its forces
    stay 0 and it adds 0 to qacc: an exact no-op, in this sweep and in
    every later one.  So each environment sweeps its contacts with a
    nonzero force, in their original order, and the batch runs its
    largest count K of them; an environment with fewer fills its last
    slots with contacts without force, whose update is that no-op.  This
    gives the full sweep's result (``gather=False``; a test holds the two
    equal bit for bit), and M^-1 J^T is needed for the visited rows
    only."""
    spans = [s for s in efc.contact_spans if s[2] > 1]
    if not efc.nf and not spans:
        return force, qacc
    B, nv = qacc.shape
    chol = inr.factor_m(d)

    def minv_rows(rows):  # J rows (B, r, nv) -> (M^-1 J^T)^T (B, r, nv)
        return inr.solve_m_matrix(chol, rows.transpose(1, 2)).transpose(1, 2)

    def dot(a, b):
        return torch.sum(a * b, -1)

    force = force.clone()
    if efc.nf:
        frows = slice(efc.ne, efc.ne + efc.nf)
        Jf = efc.J[:, frows]
        mf = minv_rows(Jf)
        a_ff = torch.clamp(dot(Jf, mf), min=_MINVAL)
        af = efc.aref[:, frows]
    # per slot: its rows (B, nrows), the pairs' J_2j - J_2j+1 and
    # aref_2j - aref_2j+1, the rows' M^-1 J^T, and the pairs' curvature
    # h_jj = A_2j,2j - 2 A_2j,2j+1 + A_2j+1,2j+1
    slots = []
    for conids, start, nrows in spans:
        order = _noslip_order(force, start, len(conids), nrows, gather)
        offs = torch.arange(nrows, device=qacc.device)
        for c in range(order.shape[1]):
            rows = start + order[:, c:c + 1] * nrows + offs
            Jc = torch.gather(efc.J, 1, rows.unsqueeze(-1).expand(
                B, nrows, nv))
            mc = minv_rows(Jc)
            A = Jc @ mc.transpose(1, 2)  # (B, nrows, nrows)
            h = (A[:, 0::2, 0::2].diagonal(dim1=1, dim2=2)
                 - 2 * A[:, 0::2, 1::2].diagonal(dim1=1, dim2=2)
                 + A[:, 1::2, 1::2].diagonal(dim1=1, dim2=2))
            ac = torch.gather(efc.aref, 1, rows)
            slots.append((rows, Jc[:, 0::2] - Jc[:, 1::2],
                          ac[:, 0::2] - ac[:, 1::2], mc,
                          torch.clamp(h, min=_MINVAL)))
    noslip.slots += len(slots)
    f_slot = [torch.gather(force, 1, s[0]) for s in slots]
    for _ in range(m.opt.noslip_iterations):
        for i in range(efc.nf):
            row = efc.ne + i
            res = dot(Jf[:, i], qacc) - af[:, i]
            fnew = torch.clamp(force[:, row] - res / a_ff[:, i],
                               -efc.floss[i], efc.floss[i])
            delta = fnew - force[:, row]
            force[:, row] = fnew
            qacc = qacc + mf[:, i] * delta.unsqueeze(-1)
        for c, (_, Jd, ad, mc, h) in enumerate(slots):
            fg = f_slot[c]
            mid = 0.5 * (fg[:, 0::2] + fg[:, 1::2])
            y = 0.5 * (fg[:, 0::2] - fg[:, 1::2])
            pos = mid > 0
            f_new = fg.clone()
            for j in range(mid.shape[1]):
                r0, r1 = 2 * j, 2 * j + 1
                mj = mid[:, j]
                yj = y[:, j] - (dot(Jd[:, j], qacc) - ad[:, j]) / h[:, j]
                yj = torch.where(pos[:, j], torch.clamp(yj, -mj, mj),
                                 torch.zeros_like(yj))
                d0 = mj + yj - f_new[:, r0]
                d1 = mj - yj - f_new[:, r1]
                f_new[:, r0] = mj + yj
                f_new[:, r1] = mj - yj
                qacc = qacc + d0.unsqueeze(-1) * mc[:, r0] \
                    + d1.unsqueeze(-1) * mc[:, r1]
            f_slot[c] = f_new
    if slots:  # no two slots of an environment share a row
        force = force.scatter(1, torch.cat([s[0] for s in slots], 1),
                              torch.cat(f_slot, 1))
    return force, qacc


#: contact slots the noslip sweep visited (summed over its calls) since
#: the count was last set to 0
noslip.slots = 0


def solve(m: Model, d: Data, efc: Efc) -> Data:
    dtype = d.qpos.dtype
    a_s = d.qacc_smooth
    M = d.qM
    J, D = efc.J, efc.D
    masks = _row_masks(m, efc)
    fl = None
    if masks[1] is not None:  # each friction-loss row's bound, 0 elsewhere
        floss = torch.zeros(efc.nefc, dtype=dtype, device=D.device)
        floss[efc.ne:efc.ne + efc.nf] = efc.floss
        fl = (floss, 0.5 * floss ** 2 / torch.clamp(D, min=1e-15))
    cones = _cone_groups(m, d, efc)
    ncone = efc.ncone

    def cost_terms(jar):
        return _cost_terms(D, jar, masks, fl)

    def with_cones(dcost, dcone):
        return torch.cat([dcost[:, :efc.nefc - ncone], dcone], dim=1)

    def cost_from_jar(x, jar):
        dx = x - a_s
        cost = 0.5 * _dot(dx, _bmv(M, dx)) + torch.sum(cost_terms(jar)[0], -1)
        return cost + _cone_eval(cones, jar)[0] if cones else cost

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
        H = M + torch.bmm(J.transpose(1, 2) * hw.unsqueeze(1), J)
        if cones:
            _, dcone, blocks, _ = _cone_eval(cones, jar, hess=True)
            dcost = with_cones(dcost, dcone)
            for (start, k, dim, *_), hc in zip(cones, blocks):
                Jg = J[:, start:start + k * dim].reshape(B, k, dim, m.nv)
                H = H + torch.bmm(Jg.reshape(B, k * dim, m.nv).transpose(
                    1, 2), (hc @ Jg).reshape(B, k * dim, m.nv))
        grad = _bmv(M, x - a_s) + torch.einsum("bkv,bk->bv", J, dcost)
        p = -linalg.chol_solve(H, grad)

        jp = _bmv(J, p)
        mp = _bmv(M, p)
        p_mp = _dot(p, mp)
        x_as = x - a_s

        def phi_derivs(alpha):
            jar_a = jar + alpha.unsqueeze(-1) * jp
            _, dcost_a, hw_a = cost_terms(jar_a)
            d2 = p_mp + torch.sum(hw_a * jp * jp, -1)
            if cones:
                _, dcone_a, _, curv = _cone_eval(cones, jar_a, jp=jp)
                dcost_a = with_cones(dcost_a, dcone_a)
                d2 = d2 + curv
            d1 = _dot(x_as + alpha.unsqueeze(-1) * p, mp) \
                + torch.sum(dcost_a * jp, -1)
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
    dcost = cost_terms(jar)[1]
    if cones:
        dcost = with_cones(dcost, _cone_eval(cones, jar)[1])
    efc_force = -dcost
    if m.opt.noslip_iterations > 0:
        efc_force, x = noslip(m, d, efc, x, efc_force)
    qfrc_constraint = torch.einsum("bkv,bk->bv", J, efc_force)

    # per-contact force (mj_contactForce): pyramidal rows are
    # n +- mu_i t_i, so normal = sum_j f_j, comp_i = mu_i (f_2i - f_2i+1);
    # an elliptic contact's rows are its force's components
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
    for conids, start, dim in efc.cone_spans:
        k = len(conids)
        ids = m.idx(conids)
        group = efc_force[:, start:start + k * dim].reshape(B, k, dim)
        contact_force[:, ids] = group[..., 0]
        contact_force_vec[:, ids, :dim] = group
    # compacted groups: each environment's chosen candidates (distinct)
    for off, start, nrows, k in efc.sel_spans:
        ids = efc.contact_selids[:, off:off + k]
        group = efc_force[:, start:start + k * nrows].reshape(B, k, nrows)
        normal = group.sum(-1)
        wrench = torch.zeros(B, k, 6, dtype=dtype, device=x.device)
        wrench[..., 0] = normal
        if nrows > 1:
            nfd = nrows // 2
            mu = torch.gather(d.contact.friction, 1, ids.unsqueeze(-1).expand(
                B, k, 5))[..., :nfd]
            wrench[..., 1:1 + nfd] = mu * (group[..., 0::2] - group[..., 1::2])
        contact_force = contact_force.scatter(1, ids, normal)
        contact_force_vec = contact_force_vec.scatter(
            1, ids.unsqueeze(-1).expand(B, k, 6), wrench)
    return d.replace(qacc=x, qfrc_constraint=qfrc_constraint,
                     contact_force=contact_force,
                     contact_force_vec=contact_force_vec, solver_niter=niter)
