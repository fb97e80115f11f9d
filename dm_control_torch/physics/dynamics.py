"""Velocity-stage dynamics: RNE bias forces and passive forces, batched.
Counterpart of ``dm_control_tpu/physics/dynamics.py``."""

from __future__ import annotations

import math

import numpy as np
import torch

from dm_control_torch.physics import kinematics as kin
from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import (
    Data, DisableBit, JointType, Model, body_ancestor_mask, body_dof_mask,
    body_subtree_mask,
)


def rne(m: Model, d: Data) -> Data:
    """Recursive Newton-Euler with qacc = 0: qfrc_bias."""
    gravity_on = not (m.opt.disableflags & DisableBit.GRAVITY)
    cacc0 = torch.cat([torch.zeros_like(m.opt.gravity),
                       -m.opt.gravity if gravity_on
                       else torch.zeros_like(m.opt.gravity)])
    per_body = body_dof_mask(m) @ (d.cdof_dot * d.qvel.unsqueeze(-1))
    cacc = cacc0 + body_ancestor_mask(m) @ per_body  # (B, nbody, 6)
    cfrc = mx.inert_mul(d.cinert, cacc) + mx.force_cross(
        d.cvel, mx.inert_mul(d.cinert, d.cvel))
    cfrc_tot = body_subtree_mask(m) @ cfrc
    qfrc_bias = torch.sum(d.cdof * cfrc_tot[:, m.idx(m.dof_bodyid)], dim=-1)
    return d.replace(qfrc_bias=qfrc_bias)


def _passive_plan(m: Model):
    """(springs, fluid): the static spring structure, the sprung scalar
    joints and the free and ball joints' sprung quaternions (their qpos
    and dof addresses and joint ids; a free joint's position part joins
    the scalar rows), and whether the medium acts at all (decided once,
    on the host, from the model's constants)."""
    stiff = m.jnt_stiffness.cpu().numpy()
    lin_q, lin_d, lin_j, quat_q, quat_d, quat_j = [], [], [], [], [], []
    for j in range(m.njnt):
        if stiff[j] == 0:
            continue
        jtype, qadr, dadr = m.jnt_type[j], m.jnt_qposadr[j], m.jnt_dofadr[j]
        if jtype in (int(JointType.HINGE), int(JointType.SLIDE)):
            lin_q.append(qadr)
            lin_d.append(dadr)
            lin_j.append(j)
            continue
        if jtype == int(JointType.FREE):
            lin_q += range(qadr, qadr + 3)
            lin_d += range(dadr, dadr + 3)
            lin_j += [j] * 3
            qadr, dadr = qadr + 3, dadr + 3
        quat_q.append([qadr + k for k in range(4)])
        quat_d.append([dadr + k for k in range(3)])
        quat_j.append(j)
    fluid = bool(float(m.opt.density) != 0.0 or float(m.opt.viscosity) != 0.0
                 or np.any(m.opt.wind.cpu().numpy() != 0.0))
    return dict(lin_q=m.idx(lin_q), lin_d=m.idx(lin_d), lin_j=m.idx(lin_j),
                quat_q=m.idx(quat_q), quat_d=m.idx(quat_d),
                quat_j=m.idx(quat_j)), fluid


def passive(m: Model, d: Data) -> Data:
    """mj_passive: joint springs (a quaternion's as the rotation from its
    spring reference, ``quat_sub``), joint dampers, tendon springs (active
    outside ``tendon_lengthspring``'s deadband) and dampers, and the
    forces of the surrounding medium."""
    qfrc = torch.zeros_like(d.qvel)
    if m.opt.disableflags & DisableBit.PASSIVE:
        return d.replace(qfrc_passive=qfrc)
    plan, fluid = m.cached("passive", lambda: _passive_plan(m))
    if len(plan["lin_q"]):
        qadr = plan["lin_q"]
        frc = -m.jnt_stiffness[plan["lin_j"]] * (d.qpos[:, qadr]
                                                  - m.qpos_spring[qadr])
        qfrc = qfrc.index_add(1, plan["lin_d"], frc)
    if len(plan["quat_j"]):
        B, qadr = d.qpos.shape[0], plan["quat_q"]
        dif = mx.quat_sub(d.qpos[:, qadr.reshape(-1)].reshape(B, -1, 4),
                          m.qpos_spring[qadr])
        frc = -m.jnt_stiffness[plan["quat_j"]].unsqueeze(-1) * dif
        qfrc = qfrc.index_add(1, plan["quat_d"].reshape(-1),
                              frc.reshape(B, -1))
    qfrc = qfrc - m.dof_damping * d.qvel
    if m.ntendon:
        low, high = m.tendon_lengthspring[:, 0], m.tendon_lengthspring[:, 1]
        ln = d.ten_length
        spring = torch.where(
            ln > high, m.tendon_stiffness * (high - ln), torch.where(
                ln < low, m.tendon_stiffness * (low - ln),
                torch.zeros_like(ln)))
        frc = spring - m.tendon_damping * d.ten_velocity
        qfrc = qfrc + torch.einsum("btv,bt->bv", d.ten_moment, frc)
    if fluid:
        qfrc = qfrc + _fluid(m, d)
    return d.replace(qfrc_passive=qfrc)


def _fluid_boxes(m: Model):
    """Per body (the world excluded) the full dimensions (nbody - 1, 3) of
    the box that has the body's mass and principal inertia."""
    mass = torch.clamp(m.body_mass[1:], min=1e-12).unsqueeze(-1)
    i0, i1, i2 = m.body_inertia[1:].unbind(-1)
    spread = torch.stack([i1 + i2 - i0, i0 + i2 - i1, i0 + i1 - i2], dim=-1)
    return torch.sqrt(torch.clamp(6.0 * spread, min=1e-12) / mass)


def _fluid(m: Model, d: Data):
    """Inertia-box fluid model (mj_inertiaBoxFluidModel): every body as the
    box of its inertia, with viscous (linear) and density (quadratic) drag
    on its 6D velocity at the CoM in the inertial frame, relative to the
    wind; all bodies at once, mapped to joint space."""
    box = m.cached("fluid_boxes", lambda: _fluid_boxes(m))
    bx, by, bz = box.unbind(-1)
    imat = d.ximat[:, 1:]
    root_com = d.subtree_com[:, m.idx(m.body_rootid[1:])]
    vel6 = mx.transform_motion(d.cvel[:, 1:], d.xipos[:, 1:] - root_com)
    lw = mx.mat_t_vec(imat, vel6[..., :3])
    lv = mx.mat_t_vec(imat, vel6[..., 3:] - m.opt.wind)

    # viscous resistance of the equivalent sphere
    diam = ((bx + by + bz) / 3.0).unsqueeze(-1)
    lfrc_t = -math.pi * diam ** 3 * m.opt.viscosity * lw
    lfrc_f = -3.0 * math.pi * diam * m.opt.viscosity * lv
    # quadratic drag
    rho = m.opt.density
    b4 = box ** 4
    others4 = torch.stack([b4[:, 1] + b4[:, 2], b4[:, 0] + b4[:, 2],
                           b4[:, 0] + b4[:, 1]], dim=-1)
    area = torch.stack([by * bz, bx * bz, bx * by], dim=-1)
    lfrc_t = lfrc_t + -rho * box * others4 / 64.0 * torch.abs(lw) * lw
    lfrc_f = lfrc_f + -0.5 * rho * area * torch.abs(lv) * lv

    jacp, jacr = kin.jac_points(m, d, d.xipos[:, 1:],
                                tuple(range(1, m.nbody)))
    return (torch.einsum("bkiv,bki->bv", jacp, mx.mat_vec(imat, lfrc_f))
            + torch.einsum("bkiv,bki->bv", jacr, mx.mat_vec(imat, lfrc_t)))


def xfrc_accumulate(m: Model, d: Data):
    """Generalized force of the Cartesian wrenches ``xfrc_applied``
    ([force, torque] at each body's CoM)."""
    bodies = tuple(range(1, m.nbody))
    jacp, jacr = kin.jac_points(m, d, d.xipos[:, 1:], bodies)
    f = d.xfrc_applied[:, 1:]
    return (torch.einsum("bkiv,bki->bv", jacp, f[..., :3])
            + torch.einsum("bkiv,bki->bv", jacr, f[..., 3:]))
