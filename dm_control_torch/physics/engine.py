"""Forward dynamics pipeline and Euler/RK4 integration (mj_forward/mj_step),
batched.  Counterpart of ``dm_control_tpu/physics/engine.py``: a step is a
function ``(Model, Data) -> Data`` over B environments at once."""

from __future__ import annotations

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
    Data, IntegratorType, JointType, Model,
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
