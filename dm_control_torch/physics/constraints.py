"""Soft-constraint row assembly (mj_makeConstraint), batched.

Counterpart of ``dm_control_tpu/physics/constraints.py``: equality rows
(CONNECT 3 an equality, WELD 6, JOINT and TENDON 1), dof friction loss,
limits on hinge/slide and ball joints and on tendons, and contact rows
with condim 1, pyramidal condim 3, 4 and 6, or elliptic cones.  The rows
come in the JAX package's order: equality (in the model's order), then
friction loss, then limits (hinge/slide joints, then ball joints, then
tendons), then contacts by condim.  The row structure is static per
model; rows MuJoCo would not instantiate (dist >= margin) are carried
with D = 0.  A model with constraints disabled, or with nothing to tie or
limit and contacts off, gets zero rows.  With ``opt.contact_cap`` set, a
float32 state keeps only the deepest contacts of each condim group
(``_contact_rows_compact``).  DISTANCE equalities raise
``NotImplementedError``, as in the JAX package.

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
from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import (
    Data, DisableBit, EqType, JointType, Model, static_field,
)

_MINVAL = 1e-15
_MINIMP = 0.0001
_MAXIMP = 0.9999

# Row kinds (the JAX package's values): an equality row is always active,
# a friction-loss row a Huber cost, a unilateral row (limit or pyramidal
# contact) active where J qacc - aref < 0, and the rows of an elliptic
# cone are costed per contact.
EQUALITY = 0
FRICTIONLOSS = 1
LIMIT = 2
CONE = 3


@dataclasses.dataclass
class Efc:
    """The assembled constraint system, batch-first: ``ne`` equality rows
    (always active), then ``nf`` friction-loss rows, then unilateral rows
    (active where J qacc - aref < 0), then ``ncone`` rows of elliptic
    cones (``cone_spans``)."""

    J: torch.Tensor  # (B, nefc, nv)
    D: torch.Tensor  # (B, nefc)
    R: torch.Tensor  # (B, nefc)
    aref: torch.Tensor  # (B, nefc)
    pos: torch.Tensor  # (B, nefc)
    floss: torch.Tensor = None  # (nf,) the friction-loss rows' bounds
    # per condim group: (contact ids, first row, rows per contact)
    contact_spans: Tuple[Tuple[Tuple[int, ...], int, int], ...] = \
        static_field(default=())
    # per elliptic condim group: (contact ids, first row, condim); each
    # contact has ``condim`` consecutive rows: normal, then friction
    cone_spans: Tuple[Tuple[Tuple[int, ...], int, int], ...] = \
        static_field(default=())
    ne: int = static_field(default=0)
    nf: int = static_field(default=0)
    # contact compaction (``_contact_rows_compact``), per condim group:
    # (offset into contact_selids, first row, rows per contact, k), the
    # group's k contacts chosen per environment; contact_selids (B, nsel)
    # holds their candidate ids, for the forces' scatter back
    sel_spans: Tuple[Tuple[int, int, int, int], ...] = \
        static_field(default=())
    contact_selids: torch.Tensor = None

    @property
    def ncone(self) -> int:
        return sum(len(ids) * dim for ids, _, dim in self.cone_spans)

    @property
    def kind(self) -> Tuple[int, ...]:
        nuni = self.nefc - self.ne - self.nf - self.ncone
        return ((EQUALITY,) * self.ne + (FRICTIONLOSS,) * self.nf
                + (LIMIT,) * nuni + (CONE,) * self.ncone)

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
        self.raw: List[tuple] = []
        self.nrows = 0

    def add(self, J, pos, solref, solimp, diag, vel, active):
        assert not self.raw, "rows added after raw rows break the order"
        B, r = pos.shape
        self.parts.append((J, pos, solref.expand(B, r, 2),
                           solimp.expand(B, r, 5), diag.expand(B, r), vel,
                           active))
        self.nrows += r

    def add_raw(self, J, aref, D, R, pos):
        """Rows whose aref, D and R are computed already (the elliptic
        cones'); they come after every row of ``add``."""
        self.raw.append((J, aref, D, R, pos))
        self.nrows += pos.shape[1]

    def build(self, spans=((), ()), ne=0, floss=None,
              sel=((), None)) -> Efc:
        m = self.m
        contact_spans, cone_spans = spans
        if not self.nrows:
            z = torch.zeros(self.B, 0, dtype=m.dtype, device=m.device)
            return Efc(J=z.new_zeros(self.B, 0, m.nv), D=z, R=z, aref=z,
                       pos=z)
        rows = []
        if self.parts:
            J, pos, solref, solimp, diag, vel, active = (
                torch.cat(x, dim=1) for x in zip(*self.parts))
            k, b, imp = kbi(m, solref, solimp, pos)
            aref = -b * vel - k * pos
            r_reg = torch.clamp((1.0 - imp) / imp * diag, min=_MINVAL)
            d_vec = torch.where(active, 1.0 / r_reg, torch.zeros_like(r_reg))
            rows.append((J, aref, d_vec, r_reg, pos))
        J, aref, d_vec, r_reg, pos = (
            torch.cat(x, dim=1) for x in zip(*rows, *self.raw))
        return Efc(J=J, D=d_vec, R=r_reg, aref=aref, pos=pos, floss=floss,
                   contact_spans=contact_spans, cone_spans=cone_spans, ne=ne,
                   nf=0 if floss is None else floss.shape[0],
                   sel_spans=sel[0], contact_selids=sel[1])


def _check_ported(m: Model):
    dis = m.opt.disableflags
    if dis & (DisableBit.CONSTRAINT | DisableBit.EQUALITY):
        return True
    for e in range(m.neq):
        if m.eq_type[e] == int(EqType.DISTANCE):
            raise NotImplementedError(
                f"equality {e}: DISTANCE equality constraints are not "
                f"implemented (nor in the JAX package)")
    return True


def make_constraint(m: Model, d: Data) -> Efc:
    m.cached("constraints_checked", lambda: _check_ported(m))
    blocks = _Blocks(m, d.qpos.shape[0])
    dis = m.opt.disableflags
    spans: Tuple = ((), ())
    sel: Tuple = ((), None)
    ne = 0
    floss = None
    if not dis & DisableBit.CONSTRAINT:
        if not dis & DisableBit.EQUALITY:
            _equality_rows(m, d, blocks)
            ne = blocks.nrows
        if not dis & DisableBit.FRICTIONLOSS:
            floss = _frictionloss_rows(m, d, blocks)
        if not dis & DisableBit.LIMIT:
            _limit_rows(m, d, blocks)
        if not dis & DisableBit.CONTACT:
            if _compacts(m, d):
                sel = _contact_rows_compact(m, d, blocks, m.opt.contact_cap)
            else:
                spans = _contact_rows(m, d, blocks)
    return blocks.build(spans, ne, floss, sel)


def _compacts(m: Model, d: Data) -> bool:
    """Contact compaction engages, as in the JAX package, where
    ``opt.contact_cap`` is set, the state is float32, the cones are
    pyramidal, noslip is off and some condim group has more candidates
    than the cap (the selection is per group: a group under the cap
    would drop no row)."""
    dims = d.contact.dim
    return (m.opt.contact_cap > 0 and d.qpos.dtype == torch.float32
            and m.opt.cone != 1 and m.opt.noslip_iterations == 0
            and max((dims.count(c) for c in set(dims)), default=0)
            > m.opt.contact_cap)


def _equality_plan(m: Model, etype: EqType):
    """Static structure of the equalities of one type, or None without
    any: their ids, the first and second object (for JOINT and TENDON the
    second clamped to 0 where there is none, with ``has2`` 0)."""
    ids = [e for e in range(m.neq) if m.eq_type[e] == int(etype)]
    if not ids:
        return None
    obj2 = [m.eq_obj2id[e] for e in ids]
    return dict(
        ids=m.idx(ids), eqs=ids, obj1=[m.eq_obj1id[e] for e in ids],
        obj2=[max(o, 0) for o in obj2],
        has2=torch.tensor([float(o >= 0) for o in obj2], dtype=m.dtype,
                          device=m.device))


#: rows of one equality of each type, in the JAX package's order within it
_EQ_ROWS = {EqType.JOINT: 1, EqType.TENDON: 1, EqType.CONNECT: 3,
            EqType.WELD: 6}


def _equality_layout(m: Model):
    """The plans by type, and the static permutation that puts the rows
    of the types (built type by type, in ``_EQ_ROWS``' order) back into
    the model's order of equalities, or None where they are in it; and
    each row's equality id."""
    plans, eqs = {}, []
    for etype, nrow in _EQ_ROWS.items():
        plan = _equality_plan(m, etype)
        if plan is not None:
            plans[etype] = plan
            eqs += [e for e in plan["eqs"] for _ in range(nrow)]
    order = np.argsort(np.asarray(eqs), kind="stable")
    rows = m.idx(np.asarray(eqs)[order])
    if np.array_equal(order, np.arange(len(eqs))):
        return plans, None, rows
    return plans, m.idx(order), rows


def _poly_rows(m: Model, plan, x1, x2, J1, J2, w1, w2):
    """(J, pos, diag) of the rows x1 - poly(x2) = 0 with poly the quartic
    ``eq_data[:5]``; without a second object the row is x1 - poly[0] = 0."""
    poly = m.eq_data[plan["ids"], :5]  # (E, 5)
    has2 = plan["has2"]
    x2 = x2 * has2
    val = poly[:, 0] + x2 * (poly[:, 1] + x2 * (poly[:, 2] + x2 * (
        poly[:, 3] + x2 * poly[:, 4])))
    dpoly = poly[:, 1] + x2 * (2 * poly[:, 2] + x2 * (
        3 * poly[:, 3] + x2 * 4 * poly[:, 4]))
    J = J1 - (dpoly * has2).unsqueeze(-1) * J2
    return J, x1 - val, (w1 + has2 * w2).expand_as(x1)


def _body_points(m: Model, d: Data, plan, anchor1, anchor2):
    """The two bodies' anchor points in the world (B, E, 3) each, and the
    difference of their Jacobians, translational and rotational
    (B, E, 3, nv) each."""
    b1, b2 = plan["obj1"], plan["obj2"]
    i1, i2 = m.idx(b1), m.idx(b2)
    p1 = d.xpos[:, i1] + mx.mat_vec(d.xmat[:, i1], anchor1)
    p2 = d.xpos[:, i2] + mx.mat_vec(d.xmat[:, i2], anchor2)
    jac1p, jac1r = kin.jac_points(m, d, p1, b1)
    jac2p, jac2r = kin.jac_points(m, d, p2, b2)
    return p1, p2, jac1p - jac2p, jac1r - jac2r


def _connect_rows(m: Model, d: Data, plan):
    """Three rows a CONNECT: the two bodies' anchors coincide."""
    data = m.eq_data[plan["ids"]]
    p1, p2, jacp, _ = _body_points(m, d, plan, data[:, :3], data[:, 3:6])
    biw = m.body_invweight0
    diag = biw[m.idx(plan["obj1"]), 0] + biw[m.idx(plan["obj2"]), 0]
    B, E = p1.shape[:2]
    return (jacp.reshape(B, E * 3, -1), (p1 - p2).reshape(B, E * 3),
            torch.repeat_interleave(diag, 3).expand(B, E * 3))


def _weld_rows(m: Model, d: Data, plan):
    """Six rows a WELD: three of position (both bodies' points at the
    anchor, in each body's own frame, as the JAX package takes them),
    then three of orientation against ``relpose``, scaled by
    ``torquescale``."""
    data = m.eq_data[plan["ids"]]
    anchor, ts = data[:, :3], data[:, 10:11]
    p1, p2, jacp, jacr = _body_points(m, d, plan, anchor, anchor)
    i1, i2 = m.idx(plan["obj1"]), m.idx(plan["obj2"])
    q2 = mx.quat_mul(d.xquat[:, i2], data[:, 6:10])
    rot = mx.quat_sub(d.xquat[:, i1], q2) * ts
    biw = m.body_invweight0
    J = torch.cat([jacp, jacr * ts.unsqueeze(-1)], dim=-2)
    pos = torch.cat([p1 - p2, rot], dim=-1)
    B, E = pos.shape[:2]
    diag = torch.stack([biw[i1, 0] + biw[i2, 0], biw[i1, 1] + biw[i2, 1]],
                       dim=-1)
    return (J.reshape(B, E * 6, -1), pos.reshape(B, E * 6),
            torch.repeat_interleave(diag, 3, dim=-1).reshape(-1).expand(
                B, E * 6))


def _equality_rows(m: Model, d: Data, blocks: _Blocks):
    """The equalities' rows, in the model's order: 3 a CONNECT, 6 a WELD,
    1 a JOINT or TENDON."""
    if not m.neq:
        return
    B = d.qpos.shape[0]
    plans, order, rows = m.cached("equality_layout",
                                  lambda: _equality_layout(m))
    parts = []
    plan = plans.get(EqType.JOINT)
    if plan is not None:
        q = d.qpos - m.qpos0
        j1, j2 = plan["obj1"], plan["obj2"]
        a1 = m.idx([m.jnt_qposadr[j] for j in j1])
        a2 = m.idx([m.jnt_qposadr[j] for j in j2])
        d1 = m.idx([m.jnt_dofadr[j] for j in j1])
        d2 = m.idx([m.jnt_dofadr[j] for j in j2])
        eye = m.cached("eye_nv", lambda: torch.eye(
            m.nv, dtype=m.dtype, device=m.device))
        parts.append(_poly_rows(
            m, plan, q[:, a1], q[:, a2], eye[d1].expand(B, -1, -1),
            eye[d2].expand(B, -1, -1), m.dof_invweight0[d1],
            m.dof_invweight0[d2]))
    plan = plans.get(EqType.TENDON)
    if plan is not None:
        ln = d.ten_length - m.tendon_length0
        t1, t2 = m.idx(plan["obj1"]), m.idx(plan["obj2"])
        parts.append(_poly_rows(
            m, plan, ln[:, t1], ln[:, t2], d.ten_moment[:, t1],
            d.ten_moment[:, t2], m.tendon_invweight0[t1],
            m.tendon_invweight0[t2]))
    if EqType.CONNECT in plans:
        parts.append(_connect_rows(m, d, plans[EqType.CONNECT]))
    if EqType.WELD in plans:
        parts.append(_weld_rows(m, d, plans[EqType.WELD]))
    J, pos, diag = (torch.cat(x, dim=1) for x in zip(*parts))
    if order is not None:  # back into the model's order
        J, pos, diag = J[:, order], pos[:, order], diag[:, order]
    blocks.add(J, pos, m.eq_solref[rows], m.eq_solimp[rows], diag,
               torch.einsum("bkv,bv->bk", J, d.qvel),
               active=torch.ones_like(pos, dtype=torch.bool))


def _frictionloss_plan(m: Model):
    """(dof ids, their unit rows (F, nv)) of the dofs with friction loss,
    or None without any."""
    dofs = np.nonzero(m.dof_frictionloss.cpu().numpy() > 0)[0]
    if not dofs.size:
        return None
    J = torch.zeros(dofs.size, m.nv, dtype=m.dtype, device=m.device)
    J[torch.arange(dofs.size, device=m.device), m.idx(dofs)] = 1.0
    return m.idx(dofs), J


def _frictionloss_rows(m: Model, d: Data, blocks: _Blocks):
    """One row per dof with friction loss, at pos 0; returns the rows'
    bounds (F,), or None without any row."""
    plan = m.cached("frictionloss_plan", lambda: _frictionloss_plan(m))
    if plan is None:
        return None
    dofs, J = plan
    B = d.qpos.shape[0]
    vel = d.qvel[:, dofs]
    blocks.add(J.expand(B, *J.shape), torch.zeros_like(vel),
               m.dof_solref[dofs], m.dof_solimp[dofs], m.dof_invweight0[dofs],
               vel, active=torch.ones_like(vel, dtype=torch.bool))
    return m.dof_frictionloss[dofs]


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
    """Two rows per limited hinge/slide joint, lower (+1) and upper (-1),
    then one per limited ball joint, then two per limited tendon."""
    _joint_limit_rows(m, d, blocks)
    _ball_limit_rows(m, d, blocks)
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


def _ball_limit_plan(m: Model):
    balls = [j for j in range(m.njnt)
             if m.jnt_limited[j] and m.jnt_type[j] == int(JointType.BALL)]
    if not balls:
        return None
    jidx = m.idx(balls)
    dadr = [m.jnt_dofadr[j] for j in balls]
    return dict(
        qadr=m.idx([[m.jnt_qposadr[j] + k for k in range(4)]
                    for j in balls]),
        dofs=m.idx([[a + k for k in range(3)] for a in dadr]),
        jidx=jidx, maxang=torch.maximum(m.jnt_range[jidx, 0],
                                        m.jnt_range[jidx, 1]),
        diag=m.dof_invweight0[m.idx(dadr)])


def _ball_limit_rows(m: Model, d: Data, blocks: _Blocks):
    """One row per limited ball joint: its rotation angle stays within
    the larger of its range's ends, along minus the rotation's axis."""
    plan = m.cached("ball_limit_plan", lambda: _ball_limit_plan(m))
    if plan is None:
        return
    B = d.qpos.shape[0]
    rotvec = mx.quat_to_axis_angle(
        d.qpos[:, plan["qadr"]].reshape(B, -1, 4))
    angle = mx.norm(rotvec)
    axis = rotvec / torch.clamp(angle, min=_MINVAL).unsqueeze(-1)
    pos = plan["maxang"] - angle - m.jnt_margin[plan["jidx"]]
    L = pos.shape[1]
    J = d.qpos.new_zeros(B, L, m.nv)
    J[:, torch.arange(L, device=m.device).repeat_interleave(3),
      plan["dofs"]] = -axis.reshape(B, -1)
    blocks.add(J, pos, m.jnt_solref[plan["jidx"]],
               m.jnt_solimp[plan["jidx"]], plan["diag"],
               torch.einsum("bkv,bv->bk", J, d.qvel), active=pos < 0)


def _contact_rows(m: Model, d: Data, blocks: _Blocks):
    """Contact rows grouped by condim: condim 1 gives one normal row, a
    pyramidal condim c gives 2 (c - 1) rows n +- mu_i t_i, ordered
    (+t0, -t0, +t1, -t1, ...), an elliptic condim c gives c rows n, t0,
    t1, ... (``_elliptic_rows``).  The first two directions are the
    frame's tangents on the translational Jacobian; the torsional (condim
    4) and the two rolling ones (condim 6) are the frame's axes on the
    rotational Jacobian.  Returns (pyramidal spans, elliptic spans)."""
    con = d.contact
    ncon = len(con.dim)
    if ncon == 0:
        return (), ()
    b1s = tuple(m.geom_bodyid[g] for g in con.geom1)
    b2s = tuple(m.geom_bodyid[g] for g in con.geom2)
    jac1p, jac1r = kin.jac_points(m, d, con.pos, b1s)
    jac2p, jac2r = kin.jac_points(m, d, con.pos, b2s)
    jdp = jac2p - jac1p  # (B, ncon, 3, nv)
    jdr = jac2r - jac1r

    def proj(row, gidx, jd=jdp):
        return torch.einsum("bki,bkiv->bkv", con.frame[:, gidx, row],
                            jd[:, gidx])

    pos_eff = con.dist - con.includemargin
    iw = m.body_invweight0[:, 0]
    inv = iw[m.idx(b1s)] + iw[m.idx(b2s)]  # (ncon,)

    elliptic = m.opt.cone == 1
    dims = np.array(con.dim)
    spans, cone_spans = [], []
    row_base = blocks.nrows
    for condim in sorted(set(con.dim)):
        idx = np.nonzero(dims == condim)[0]
        k = idx.size
        gidx = m.idx(idx)
        pe = pos_eff[:, gidx]
        jn = proj(0, gidx)
        if condim > 1 and elliptic:
            J = torch.stack([jn] + [
                proj(1 + i, gidx) if i < 2 else proj(i - 2, gidx, jdr)
                for i in range(condim - 1)], dim=2)  # (B, k, condim, nv)
            _elliptic_rows(m, d, blocks, J, pe, gidx, inv[gidx])
            cone_spans.append((tuple(int(c) for c in idx), row_base,
                               condim))
            row_base += k * condim
            continue
        nrows = _pyramid_rows(
            m, d, blocks, condim, jn, lambda i: proj(1 + i, gidx)
            if i < 2 else proj(i - 2, gidx, jdr), pe, con.solref[:, gidx],
            con.solimp[:, gidx], con.friction[:, gidx], inv[gidx])
        spans.append((tuple(int(c) for c in idx), row_base, nrows))
        row_base += k * nrows
    return tuple(spans), tuple(cone_spans)


def _pyramid_rows(m: Model, d: Data, blocks: _Blocks, condim, jn, tangent,
                  pe, solref, solimp, friction, inv):
    """Adds the rows of k contacts of one condim: one normal row for
    condim 1; for a pyramidal condim c, 2 (c - 1) rows n +- mu_i t_i,
    ordered (+t0, -t0, +t1, -t1, ...).  ``jn`` (B, k, nv) is the normal's
    Jacobian, ``tangent(i)`` friction direction i's; ``pe``, ``solref``,
    ``solimp`` and ``friction`` are the contacts' (B, k, ...), ``inv``
    their bodies' summed inverse weights.  Returns the rows per contact."""
    B, k = pe.shape
    if condim == 1:
        blocks.add(jn, pe, solref, solimp, inv,
                   torch.einsum("bkv,bv->bk", jn, d.qvel), active=pe < 0)
        return 1
    if condim not in (3, 4, 6):
        raise NotImplementedError(f"contacts with condim {condim} do not "
                                  f"exist")
    nrows = 2 * (condim - 1)
    mu0 = friction[..., 0]
    inv_pyr = (inv + mu0 * mu0 * inv) * 2.0 * mu0 * mu0 / m.opt.impratio
    rows = []
    for i in range(condim - 1):
        mu_i = friction[..., i].unsqueeze(-1)
        ti = tangent(i)
        rows += [jn + mu_i * ti, jn - mu_i * ti]
    J = torch.stack(rows, dim=2).reshape(B, k * nrows, m.nv)
    rep = lambda x: torch.repeat_interleave(x, nrows, dim=1)  # noqa: E731
    pr = rep(pe)
    blocks.add(J, pr, rep(solref), rep(solimp), rep(inv_pyr),
               torch.einsum("bkv,bv->bk", J, d.qvel), active=pr < 0)
    return nrows


def _contact_rows_compact(m: Model, d: Data, blocks: _Blocks, cap: int):
    """Contact rows of the ``cap`` deepest candidates of each condim group,
    chosen per environment (a group with at most ``cap`` keeps all, in
    order); the rows of ``_pyramid_rows``, on Jacobians at each
    environment's own bodies.  The candidate arrays in ``d.contact`` keep
    their full size.  Returns (sel_spans, contact_selids) for the solver
    to scatter the forces back (``Efc``).  Counterpart of
    ``dm_control_tpu/physics/constraints.py::_contact_rows_compact``.

    ``jax.lax.top_k`` of -depth puts the lower index first among equal
    depths (a box lying flat has four); a stable ascending sort of the
    depth does the same (``torch.topk`` promises no order)."""
    con = d.contact
    B = d.qpos.shape[0]
    pos_eff = con.dist - con.includemargin
    geom_body = m.cached("geom_bodyid", lambda: m.idx(m.geom_bodyid))
    g1, g2 = m.idx(con.geom1), m.idx(con.geom2)
    iw = m.body_invweight0[:, 0]
    dims = np.array(con.dim)
    sel_spans, sel_parts = [], []
    sel_off, row_base = 0, blocks.nrows
    for condim in sorted(set(con.dim)):
        gidx = m.idx(np.nonzero(dims == condim)[0])
        k = gidx.shape[0]
        kk = min(k, cap)
        if kk < k:
            gsel = gidx[torch.sort(pos_eff[:, gidx], dim=1,
                                   stable=True).indices[:, :kk]]
        else:
            gsel = gidx.expand(B, k)

        def take(x):  # the selected rows of a (B, ncon, ...) tensor
            return torch.gather(x, 1, gsel.reshape(
                B, kk, *(1,) * (x.ndim - 2)).expand(B, kk, *x.shape[2:]))

        b1, b2 = geom_body[g1[gsel]], geom_body[g2[gsel]]  # (B, kk)
        pos = take(con.pos)
        jac1p, jac1r = kin.jac_points(m, d, pos, b1)
        jac2p, jac2r = kin.jac_points(m, d, pos, b2)
        jdp = jac2p - jac1p
        frame = take(con.frame)

        def proj(row, jd=jdp):
            return torch.einsum("bki,bkiv->bkv", frame[:, :, row], jd)

        jdr = jac2r - jac1r
        nrows = _pyramid_rows(
            m, d, blocks, condim, proj(0), lambda i: proj(1 + i)
            if i < 2 else proj(i - 2, jdr), take(pos_eff), take(con.solref),
            take(con.solimp), take(con.friction), iw[b1] + iw[b2])
        sel_spans.append((sel_off, row_base, nrows, kk))
        sel_parts.append(gsel)
        sel_off += kk
        row_base += kk * nrows
    return tuple(sel_spans), torch.cat(sel_parts, dim=1)


def _elliptic_rows(m: Model, d: Data, blocks: _Blocks, J, pos, gidx, inv):
    """The rows of k elliptic contacts of one condim c, J (B, k, c, nv),
    at ``pos`` (B, k) with the bodies' summed inverse weights ``inv``:
    the normal row with its own impedance (D0, aref -b vel - k pos), each
    friction row j with D0 impratio (mu_j / mu_0)^2 and aref -b vel, with
    no position term; R = 1 / D.  Added as computed (raw) rows."""
    con = d.contact
    B, k, c, nv = J.shape
    kk, b, imp = kbi(m, con.solref[:, gidx], con.solimp[:, gidx], pos)
    r0 = torch.clamp((1.0 - imp) / imp * inv, min=_MINVAL)
    d0 = torch.where(pos < 0, 1.0 / r0, torch.zeros_like(r0))
    fri = con.friction[:, gidx, :c - 1]
    dj = d0.unsqueeze(-1) * m.opt.impratio * (fri / fri[..., :1]) ** 2
    vel = torch.einsum("bkrv,bv->bkr", J, d.qvel)
    aref = -b.unsqueeze(-1) * vel
    aref[..., 0] = aref[..., 0] - kk * pos
    D = torch.cat([d0.unsqueeze(-1), dj], dim=-1)  # (B, k, c)
    R = 1.0 / torch.clamp(D, min=_MINVAL)
    blocks.add_raw(J.reshape(B, k * c, nv), aref.reshape(B, -1),
                   D.reshape(B, -1), R.reshape(B, -1),
                   torch.repeat_interleave(pos, c, dim=1))

