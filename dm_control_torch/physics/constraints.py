"""Soft-constraint row assembly (mj_makeConstraint), batched.

Counterpart of ``dm_control_tpu/physics/constraints.py`` for limits on
hinge/slide joints and on tendons, and contact rows with condim 1 or
pyramidal condim 3.  The row structure is static per model; rows MuJoCo
would not instantiate (dist >= margin) are carried with D = 0.  A model
with constraints disabled, or with nothing to limit and contacts off, gets
zero rows.  Equality rows, friction loss, ball-joint limits, elliptic
cones and other condims raise ``NotImplementedError``.

MuJoCo's soft-constraint model: each row has impedance d(pos) from solimp,
reference acceleration aref from solref, and regularization
R = (1 - d) / d * diagApprox, D = 1 / R.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from dm_control_torch.physics import kinematics as kin
from dm_control_torch.physics.model import (
    Data, DisableBit, JointType, Model, static_field,
)

_MINVAL = 1e-15
_MINIMP = 0.0001
_MAXIMP = 0.9999


@dataclasses.dataclass
class Efc:
    """The assembled constraint system, batch-first.  Every row is
    unilateral (active where J qacc - aref < 0)."""

    J: torch.Tensor  # (B, nefc, nv)
    D: torch.Tensor  # (B, nefc)
    R: torch.Tensor  # (B, nefc)
    aref: torch.Tensor  # (B, nefc)
    pos: torch.Tensor  # (B, nefc)
    # per condim group: (contact ids, first row, rows per contact)
    contact_spans: Tuple[Tuple[Tuple[int, ...], int, int], ...] = \
        static_field(default=())

    @property
    def nefc(self) -> int:
        return self.J.shape[1]


def impedance(solimp, pos):
    """Constraint impedance d(pos) from the solimp spline."""
    dmin, dmax, width, mid, power = (solimp[..., i] for i in range(5))
    x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=_MINVAL),
                    0.0, 1.0)
    mid = torch.clamp(mid, _MINIMP, _MAXIMP)
    power = torch.clamp(power, min=1.0)
    dmin = torch.clamp(dmin, _MINIMP, _MAXIMP)
    dmax = torch.clamp(dmax, _MINIMP, _MAXIMP)
    y_lo = (x / mid) ** power * mid
    y_hi = 1.0 - ((1.0 - x) / (1.0 - mid)) ** power * (1.0 - mid)
    y = torch.where(x < mid, y_lo, y_hi)
    return torch.clamp(dmin + y * (dmax - dmin), _MINIMP, _MAXIMP)


def kbi(m: Model, solref, solimp, pos):
    """Stiffness, damping and impedance from solref/solimp:
    k = d / (dmax^2 tau^2 zeta^2), b = 2 / (dmax tau)."""
    imp = impedance(solimp, pos)
    dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
    timeconst, dampratio = solref[..., 0], solref[..., 1]
    if not (m.opt.disableflags & DisableBit.REFSAFE):
        timeconst = torch.maximum(timeconst, 2.0 * m.opt.timestep)
    k_std = imp / torch.clamp((dmax * timeconst * dampratio) ** 2,
                              min=_MINVAL)
    b_std = 2.0 / torch.clamp(dmax * timeconst, min=_MINVAL)
    direct = solref[..., 0] <= 0
    k = torch.where(direct, -solref[..., 0] * imp, k_std)
    b = torch.where(direct, -solref[..., 1], b_std)
    return k, b, imp


class _Blocks:
    """Accumulates blocks of rows; every block is (B, r, ...)."""

    def __init__(self, m: Model, batch: int):
        self.m = m
        self.B = batch
        self.parts: List[tuple] = []
        self.nrows = 0

    def add(self, J, pos, solref, solimp, diag, vel, active):
        B, r = pos.shape
        self.parts.append((J, pos, solref.expand(B, r, 2),
                           solimp.expand(B, r, 5), diag.expand(B, r), vel,
                           active))
        self.nrows += r

    def build(self, contact_spans) -> Efc:
        m = self.m
        if not self.parts:
            z = torch.zeros(self.B, 0, dtype=m.dtype, device=m.device)
            return Efc(J=z.new_zeros(self.B, 0, m.nv), D=z, R=z, aref=z,
                       pos=z)
        J, pos, solref, solimp, diag, vel, active = (
            torch.cat(x, dim=1) for x in zip(*self.parts))
        k, b, imp = kbi(m, solref, solimp, pos)
        aref = -b * vel - k * pos
        r_reg = torch.clamp((1.0 - imp) / imp * diag, min=_MINVAL)
        d_vec = torch.where(active, 1.0 / r_reg, torch.zeros_like(r_reg))
        return Efc(J=J, D=d_vec, R=r_reg, aref=aref, pos=pos,
                   contact_spans=contact_spans)


def _check_ported(m: Model):
    dis = m.opt.disableflags
    if dis & DisableBit.CONSTRAINT:
        return
    if m.neq and not dis & DisableBit.EQUALITY:
        raise NotImplementedError("equality constraints are not ported yet "
                                  "(ROADMAP A1: quadruped)")
    if not dis & DisableBit.FRICTIONLOSS and bool(
            (m.dof_frictionloss > 0).any()):
        raise NotImplementedError("friction loss is not ported yet "
                                  "(ROADMAP A3: finger, manipulator and "
                                  "stacker)")
    if not dis & DisableBit.LIMIT:
        for j in range(m.njnt):
            if m.jnt_limited[j] and m.jnt_type[j] == int(JointType.BALL):
                raise NotImplementedError("ball-joint limits are not ported "
                                          "yet (ROADMAP A5: humanoid_CMU, "
                                          "dog and lqr)")
    if m.opt.contact_cap:
        raise NotImplementedError("contact compaction is not ported yet "
                                  "(ROADMAP A5: humanoid_CMU, dog and lqr)")
    if m.opt.cone != 0:
        raise NotImplementedError("elliptic cones are not ported yet "
                                  "(ROADMAP A3: finger, manipulator and "
                                  "stacker)")
    return True


def make_constraint(m: Model, d: Data) -> Efc:
    m.cached("constraints_checked", lambda: _check_ported(m))
    blocks = _Blocks(m, d.qpos.shape[0])
    dis = m.opt.disableflags
    spans: Tuple = ()
    if not dis & DisableBit.CONSTRAINT:
        if not dis & DisableBit.LIMIT:
            _limit_rows(m, d, blocks)
        if not dis & DisableBit.CONTACT:
            spans = _contact_rows(m, d, blocks)
    return blocks.build(spans)


def _limit_plan(m: Model):
    scalar = [j for j in range(m.njnt)
              if m.jnt_limited[j] and m.jnt_type[j] in (int(JointType.HINGE),
                                                        int(JointType.SLIDE))]
    if not scalar:
        return None
    dadr = [m.jnt_dofadr[j] for j in scalar]
    L = len(scalar)
    J = torch.zeros(2 * L, m.nv, dtype=m.dtype, device=m.device)
    signs = torch.tensor([1.0, -1.0] * L, dtype=m.dtype, device=m.device)
    J[torch.arange(2 * L, device=m.device), m.idx(np.repeat(dadr, 2))] = signs
    jidx = m.idx(scalar)
    rep2 = lambda x: torch.repeat_interleave(x, 2, dim=0)  # noqa: E731
    return dict(qadr=m.idx([m.jnt_qposadr[j] for j in scalar]),
                dadr=m.idx(dadr), jidx=jidx, J=J, signs=signs,
                margin=rep2(m.jnt_margin[jidx]),
                solref=rep2(m.jnt_solref[jidx]),
                solimp=rep2(m.jnt_solimp[jidx]),
                diag=rep2(m.dof_invweight0[m.idx(dadr)]))


def _limit_rows(m: Model, d: Data, blocks: _Blocks):
    """Two rows per limited hinge/slide joint, then two per limited
    tendon: lower (+1), upper (-1)."""
    _joint_limit_rows(m, d, blocks)
    limited = [t for t in range(m.ntendon) if m.tendon_limited[t]]
    if not limited:
        return
    B = d.qpos.shape[0]
    tidx = m.idx(limited)
    signs = m.cached("tendon_limit_signs", lambda: torch.tensor(
        [1.0, -1.0] * len(limited), dtype=m.dtype, device=m.device))
    rep2 = lambda x: torch.repeat_interleave(x, 2, dim=0)  # noqa: E731
    ln = d.ten_length[:, tidx]
    tr = m.tendon_range[tidx]
    dist = torch.stack([ln - tr[:, 0], tr[:, 1] - ln], dim=-1).reshape(B, -1)
    pos = dist - rep2(m.tendon_margin[tidx])
    J = torch.repeat_interleave(d.ten_moment[:, tidx], 2, dim=1) \
        * signs.unsqueeze(-1)
    blocks.add(J, pos, rep2(m.tendon_solref_lim[tidx]),
               rep2(m.tendon_solimp_lim[tidx]),
               rep2(m.tendon_invweight0[tidx]),
               torch.einsum("bkv,bv->bk", J, d.qvel), active=pos < 0)


def _joint_limit_rows(m: Model, d: Data, blocks: _Blocks):
    plan = m.cached("limit_plan", lambda: _limit_plan(m))
    if plan is None:
        return
    B = d.qpos.shape[0]
    q = d.qpos[:, plan["qadr"]]
    jr = m.jnt_range[plan["jidx"]]
    dist = torch.stack([q - jr[:, 0], jr[:, 1] - q], dim=-1).reshape(B, -1)
    pos = dist - plan["margin"]
    vel = torch.repeat_interleave(d.qvel[:, plan["dadr"]], 2, dim=1) \
        * plan["signs"]
    J = plan["J"].expand(B, *plan["J"].shape)
    blocks.add(J, pos, plan["solref"], plan["solimp"], plan["diag"], vel,
               active=pos < 0)


def _contact_rows(m: Model, d: Data, blocks: _Blocks):
    """Contact rows grouped by condim: condim 1 gives one normal row,
    pyramidal condim 3 gives 4 rows n +- mu_i t_i, ordered
    (+t0, -t0, +t1, -t1)."""
    con = d.contact
    ncon = len(con.dim)
    if ncon == 0:
        return ()
    B = d.qpos.shape[0]
    b1s = tuple(m.geom_bodyid[g] for g in con.geom1)
    b2s = tuple(m.geom_bodyid[g] for g in con.geom2)
    jac1p, _ = kin.jac_points(m, d, con.pos, b1s)
    jac2p, _ = kin.jac_points(m, d, con.pos, b2s)
    jdp = jac2p - jac1p  # (B, ncon, 3, nv)

    def proj(row, gidx):
        return torch.einsum("bki,bkiv->bkv", con.frame[:, gidx, row],
                            jdp[:, gidx])

    pos_eff = con.dist - con.includemargin
    iw = m.body_invweight0[:, 0]
    inv = iw[m.idx(b1s)] + iw[m.idx(b2s)]  # (ncon,)
    mu0 = con.friction[:, :, 0]  # (B, ncon)
    inv_pyr = (inv + mu0 * mu0 * inv) * 2.0 * mu0 * mu0 / m.opt.impratio

    dims = np.array(con.dim)
    spans = []
    row_base = blocks.nrows
    for condim in sorted(set(con.dim)):
        idx = np.nonzero(dims == condim)[0]
        k = idx.size
        gidx = m.idx(idx)
        pe = pos_eff[:, gidx]
        jn = proj(0, gidx)
        if condim == 1:
            nrows = 1
            blocks.add(jn, pe, con.solref[:, gidx], con.solimp[:, gidx],
                       inv[gidx], torch.einsum("bkv,bv->bk", jn, d.qvel),
                       active=pe < 0)
        elif condim == 3:
            nrows = 4
            rows = []
            for i in range(2):
                mu_i = con.friction[:, gidx, i].unsqueeze(-1)
                ti = proj(1 + i, gidx)
                rows += [jn + mu_i * ti, jn - mu_i * ti]
            J = torch.stack(rows, dim=2).reshape(B, k * nrows, m.nv)
            rep = lambda x: torch.repeat_interleave(  # noqa: E731
                x, nrows, dim=1)
            pr = rep(pe)
            blocks.add(J, pr, rep(con.solref[:, gidx]),
                       rep(con.solimp[:, gidx]), rep(inv_pyr[:, gidx]),
                       torch.einsum("bkv,bv->bk", J, d.qvel),
                       active=pr < 0)
        else:
            raise NotImplementedError(
                f"contacts with condim {condim} are not ported yet "
                f"(ROADMAP A3: finger, manipulator and stacker)")
        spans.append((tuple(int(c) for c in idx), row_base, nrows))
        row_base += k * nrows
    return tuple(spans)

