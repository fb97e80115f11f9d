"""Forward dynamics pipeline and Euler/RK4 integration (mj_forward/mj_step),
batched.  Counterpart of ``dm_control_tpu/physics/engine.py``: a step is a
function ``(Model, Data) -> Data`` over B environments at once."""

from __future__ import annotations

import numpy as np
import torch

from dm_control_torch.ops import linalg
from dm_control_torch.physics import actuation as act_mod
from dm_control_torch.physics import collision as coll
from dm_control_torch.physics import constraints as cons
from dm_control_torch.physics import dynamics as dyn
from dm_control_torch.physics import inertia as inr
from dm_control_torch.physics import kinematics as kin
from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics import sensors as sens
from dm_control_torch.physics import solver as slv
from dm_control_torch.physics.model import (
    Data, IntegratorType, JointType, Model, make_data,
)

# Divergence threshold (mjMAXVAL).
MAXVAL = 1e10


def fwd_position(m: Model, d: Data) -> Data:
    d = kin.kinematics(m, d)
    d = kin.com_pos(m, d)
    d = kin.tendon(m, d)
    d = inr.crb(m, d)
    d = coll.collision(m, d)
    return act_mod.transmission(m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
    d = act_mod.actuator_velocity(m, d)
    d = kin.tendon_velocity(m, d)
    d = kin.com_vel(m, d)
    d = dyn.rne(m, d)
    return dyn.passive(m, d)


def fwd_actuation(m: Model, d: Data) -> Data:
    return act_mod.fwd_actuation(m, d)


def fwd_acceleration(m: Model, d: Data) -> Data:
    qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_applied
                   + d.qfrc_actuator + dyn.xfrc_accumulate(m, d))
    return d.replace(qfrc_smooth=qfrc_smooth,
                     qacc_smooth=inr.solve_m(m, d, qfrc_smooth))


def fwd_constraint(m: Model, d: Data) -> Data:
    efc = cons.make_constraint(m, d)
    if efc.nefc == 0:
        return d.replace(
            qacc=d.qacc_smooth,
            qfrc_constraint=torch.zeros_like(d.qfrc_smooth),
            contact_force=torch.zeros_like(d.contact.dist),
            contact_force_vec=d.contact.dist.new_zeros(
                *d.contact.dist.shape, 6))
    return slv.solve(m, d, efc)


def forward(m: Model, d: Data) -> Data:
    """mj_forward: full forward dynamics at the current state."""
    d = fwd_position(m, d)
    d = sens.sensor_pos(m, d)
    d = fwd_velocity(m, d)
    d = sens.sensor_vel(m, d)
    d = fwd_actuation(m, d)
    d = fwd_acceleration(m, d)
    d = fwd_constraint(m, d)
    return sens.sensor_acc(m, d)


def _integrate_plan(m: Model):
    scalar_q, scalar_d, free, other = [], [], [], []
    for jid in range(m.njnt):
        jtype = m.jnt_type[jid]
        if jtype in (int(JointType.HINGE), int(JointType.SLIDE)):
            scalar_q.append(m.jnt_qposadr[jid])
            scalar_d.append(m.jnt_dofadr[jid])
        elif jtype == int(JointType.FREE):
            free.append((m.jnt_qposadr[jid], m.jnt_dofadr[jid]))
        else:
            other.append(jid)
    if other:
        raise NotImplementedError("ball joints are not ported yet "
                                  "(ROADMAP A5: composer, locomotion and "
                                  "manipulation)")
    return scalar_q, scalar_d, free


def integrate_pos(m: Model, qpos, qvel, dt):
    """mj_integratePos: qpos + qvel dt, quaternions on the manifold."""
    scalar_q, scalar_d, free = m.cached("integrate",
                                        lambda: _integrate_plan(m))
    out = qpos.clone()
    if scalar_q:
        qi = m.idx(scalar_q)
        out[:, qi] = qpos[:, qi] + dt * qvel[:, m.idx(scalar_d)]
    for qadr, dadr in free:
        out[:, qadr:qadr + 3] = qpos[:, qadr:qadr + 3] \
            + dt * qvel[:, dadr:dadr + 3]
        out[:, qadr + 3:qadr + 7] = mx.quat_integrate(
            qpos[:, qadr + 3:qadr + 7], qvel[:, dadr + 3:dadr + 6], dt)
    return out


def _advance(m: Model, d: Data, qacc, act_dot) -> Data:
    dt = m.opt.timestep
    qvel = d.qvel + dt * qacc
    act = d.act + dt * act_dot if m.na else d.act
    return d.replace(qpos=integrate_pos(m, d.qpos, qvel, dt), qvel=qvel,
                     act=act, time=d.time + dt)


def _has_damping(m: Model) -> bool:
    """Whether the Euler step is implicit in joint damping: always for a
    per-environment ``dof_damping`` (B, nv), as for a traced one in the
    JAX package; else where any dof has damping."""
    if m.dof_damping.dim() > 1:
        return True
    return m.derived("has_damping", "dof_damping",
                     lambda: bool((m.dof_damping != 0).any()))


def euler(m: Model, d: Data) -> Data:
    """mj_Euler, implicit in joint damping:
    v' = v + h (M + h diag(B))^-1 (qfrc_smooth + qfrc_constraint)."""
    if not _has_damping(m):
        return _advance(m, d, d.qacc, d.act_dot)
    mh = d.qM + m.opt.timestep * torch.diag_embed(m.dof_damping)
    qacc = linalg.chol_solve(mh, d.qfrc_smooth + d.qfrc_constraint)
    return _advance(m, d, qacc, d.act_dot)


_RK4_A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6)


def _weighted(weights, terms):
    return sum(w * t for w, t in zip(weights, terms) if w)


def rungekutta4(m: Model, d: Data) -> Data:
    """mj_RungeKutta with the classic 4th-order tableau.  ``d`` holds the
    first stage (a ``forward`` at the current state); each of the other
    three stages is a full ``forward``, warm-started from the first
    stage's qacc.  No implicit damping."""
    h = m.opt.timestep
    qvels, qaccs, act_dots = [d.qvel], [d.qacc], [d.act_dot]
    for arow in _RK4_A:
        di = d.replace(
            qpos=integrate_pos(m, d.qpos, _weighted(arow, qvels), h),
            qvel=d.qvel + h * _weighted(arow, qaccs),
            act=d.act + h * _weighted(arow, act_dots) if m.na else d.act)
        di = forward(m, di)
        qvels.append(di.qvel)
        qaccs.append(di.qacc)
        act_dots.append(di.act_dot)
    return d.replace(
        qpos=integrate_pos(m, d.qpos, _weighted(_RK4_B, qvels), h),
        qvel=d.qvel + h * _weighted(_RK4_B, qaccs),
        act=d.act + h * _weighted(_RK4_B, act_dots) if m.na else d.act,
        time=d.time + h)


def step(m: Model, d: Data) -> Data:
    """mj_step: forward dynamics + integration (Euler or RK4)."""
    d = forward(m, d)
    d = d.replace(qacc_warmstart=d.qacc)
    if m.opt.integrator == int(IntegratorType.RK4):
        return rungekutta4(m, d)
    return euler(m, d)


def check_divergence(m: Model, d: Data):
    """(B,) divergence flags: a non-finite or huge qpos or qvel."""
    def bad(x):
        return (~torch.isfinite(x) | (torch.abs(x) > MAXVAL)).any(-1)

    return bad(d.qpos) | bad(d.qvel)


def _is_simple_body(m: Model, b: int) -> bool:
    """MuJoCo's 'simple body' check (body_simple): all joints are slides
    with world-aligned axes, com at the body frame origin, identity
    orientation, and no moving ancestors
    (``dm_control_tpu/physics/engine.py::_is_simple_body``)."""
    p = m.body_parentid[b]
    while p != 0:
        if m.body_dofnum[p] > 0:
            return False
        p = m.body_parentid[p]
    if any(m.body_parentid[c] == b for c in range(m.nbody) if c != b):
        return False  # child bodies couple the mass matrix
    if m.body_jntnum[b] == 0:
        return False
    if not np.allclose(m.body_quat[b].cpu().numpy(), [1, 0, 0, 0]):
        return False
    if not np.allclose(m.body_ipos[b].cpu().numpy(), 0.0):
        return False
    jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
    for j in range(jadr, jadr + jnum):
        if m.jnt_type[j] != int(JointType.SLIDE):
            return False
        axis = np.abs(m.jnt_axis[j].cpu().numpy())
        if not (np.isclose(axis.max(), 1.0) and np.isclose(axis.sum(), 1.0)):
            return False
        if not np.allclose(m.jnt_pos[j].cpu().numpy(), 0.0):
            return False
    return True


def _minv(qm):
    """M^-1 in the JAX package's float64 order: LAPACK's lower Cholesky
    factor (scipy's potrf, which jaxlib calls on the CPU), then a forward
    and a backward triangular solve of the identity."""
    import scipy.linalg

    chol = torch.as_tensor(scipy.linalg.cholesky(
        qm.cpu().numpy(), lower=True), device=qm.device)
    eye = torch.eye(qm.shape[-1], dtype=qm.dtype, device=qm.device)
    y = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.linalg.solve_triangular(chol.T, y, upper=True)


def set_const(m: Model) -> Model:
    """mj_setConst: the constants derived from the physics at qpos0 (dof
    and body invweights, meaninertia, springdamper stiffness and damping,
    tendon rest lengths and invweights, camera offsets).  Runs once per
    compiled model at B = 1 on the model's device (``compile_model`` hands
    it the float64 model on the host), in the JAX package's order of
    operations (``dm_control_tpu/physics/engine.py::set_const``).
    M^-1 is a matrix right-hand side, which the JAX package solves outside
    its kernel with LAPACK's Cholesky factor (potrf, from scipy) and two
    triangular solves; ``_minv`` does the same, as library calls."""
    dtype, dev = m.dtype, m.device
    d = make_data(m, 1)
    d = kin.kinematics(m, d)
    d = kin.com_pos(m, d)
    d = kin.tendon(m, d)
    d = inr.crb(m, d)

    if m.nv:
        minv = _minv(d.qM[0])
        # MuJoCo (mj_setConst) assigns each free joint's 3 translational /
        # 3 rotational dofs the MEAN of their diag(M^-1) entries, and each
        # ball joint's 3 dofs likewise; scalar joints get the raw diagonal.
        diag = torch.diagonal(minv).cpu().numpy().copy()
        for j in range(m.njnt):
            adr = int(m.jnt_dofadr[j])
            jt = int(m.jnt_type[j])
            if jt == int(JointType.FREE):
                diag[adr:adr + 3] = diag[adr:adr + 3].mean()
                diag[adr + 3:adr + 6] = diag[adr + 3:adr + 6].mean()
            elif jt == int(JointType.BALL):
                diag[adr:adr + 3] = diag[adr:adr + 3].mean()
        dof_invweight0 = torch.as_tensor(diag, device=dev)
        meaninertia = torch.trace(d.qM[0]) / m.nv
    else:
        dof_invweight0 = m.dof_invweight0
        meaninertia = torch.tensor(1.0, dtype=dtype, device=dev)

    # joint/@springdamper auto-tuning (mjCModel::AutoSpringDamper): with
    # (timeconst, dampratio) both positive, stiffness = I/(tc^2 dr^2) and
    # damping = 2 I/tc, where I is the joint inertia at qpos0
    # (1/dof_invweight0)
    if any(sd[0] > 0 and sd[1] > 0 for sd in m.jnt_springdamper):
        iw = dof_invweight0.cpu().numpy()
        stiff = m.jnt_stiffness.cpu().numpy().copy()
        damp = m.dof_damping.cpu().numpy().copy()
        for j, (tc, dr) in enumerate(m.jnt_springdamper):
            if tc <= 0 or dr <= 0:
                continue
            dofs = [v for v in range(m.nv) if m.dof_jntid[v] == j]
            inertia = float(np.mean(1.0 / iw[dofs]))
            stiff[j] = inertia / (tc * tc * dr * dr)
            for v in dofs:
                damp[v] = 2.0 * inertia / tc
        m = m.replace(jnt_stiffness=torch.as_tensor(stiff, device=dev),
                      dof_damping=torch.as_tensor(damp, device=dev))

    biw = []
    for b in range(m.nbody):
        if m.nv == 0 or b == 0:
            biw.append(torch.zeros(2, dtype=dtype, device=dev))
            continue
        if _is_simple_body(m, b):
            # MuJoCo's 'simple body' fast path: invweight = [1/mass, 0]
            biw.append(torch.stack([
                1.0 / torch.clamp(m.body_mass[b], min=1e-15),
                torch.zeros((), dtype=dtype, device=dev)]))
            continue
        jacp, jacr = kin.jac(m, d, d.xipos[:, b], b)
        jt = jacp[0] @ minv @ jacp[0].T
        jr = jacr[0] @ minv @ jacr[0].T
        biw.append(torch.stack([torch.trace(jt) / 3.0,
                                torch.trace(jr) / 3.0]))
    body_invweight0 = torch.stack(biw)

    if m.ntendon:
        moment = d.ten_moment[0]
        ten_iw = torch.einsum("tv,vw,tw->t", moment, minv, moment)
        length0 = d.ten_length[0]
        # springlength < 0 resolves to the rest length at qpos0
        ls = m.tendon_lengthspring
        ls = torch.where(ls < 0, length0[:, None], ls)
        m = m.replace(tendon_length0=length0, tendon_invweight0=ten_iw,
                      tendon_lengthspring=ls)
    else:
        z = torch.zeros(0, dtype=dtype, device=dev)
        m = m.replace(tendon_length0=z, tendon_invweight0=z)

    if m.ncam:
        # each camera's world pose at qpos0, kept as the offsets the
        # track/trackcom camera modes use at render time
        bid = m.idx(m.cam_bodyid)
        xpos, xmat = d.xpos[0, bid], d.xmat[0, bid]
        cam_xpos0 = xpos + torch.einsum("cij,cj->ci", xmat, m.cam_pos)
        m = m.replace(
            cam_pos0=cam_xpos0 - xpos,
            cam_poscom0=cam_xpos0 - d.subtree_com[0, bid],
            cam_mat0=xmat @ mx.quat_to_mat(m.cam_quat),
        )

    return m.replace(
        dof_invweight0=dof_invweight0,
        body_invweight0=body_invweight0,
        stat=m.stat.replace(meaninertia=meaninertia),
    )
