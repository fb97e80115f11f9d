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
    stiff = m.jnt_stiffness.cpu().numpy()
    scalar = [j for j in range(m.njnt)
              if m.jnt_type[j] in (int(JointType.HINGE),
                                   int(JointType.SLIDE)) and stiff[j] != 0]
    if any(stiff[j] != 0 for j in range(m.njnt)
           if m.jnt_type[j] in (int(JointType.FREE), int(JointType.BALL))):
        raise NotImplementedError(
            "springs on free/ball joints are not ported yet "
            "(ROADMAP A5: composer, locomotion and manipulation)")
    # whether the medium acts at all is decided once, on the host, from
    # the model's constants
    fluid = bool(float(m.opt.density) != 0.0 or float(m.opt.viscosity) != 0.0
                 or np.any(m.opt.wind.cpu().numpy() != 0.0))
    return scalar, fluid


def passive(m: Model, d: Data) -> Data:
    """mj_passive: scalar-joint springs, joint dampers, tendon springs
    (active outside ``tendon_lengthspring``'s deadband) and dampers, and
    the forces of the surrounding medium."""
    qfrc = torch.zeros_like(d.qvel)
    if m.opt.disableflags & DisableBit.PASSIVE:
        return d.replace(qfrc_passive=qfrc)
    scalar, fluid = m.cached("passive", lambda: _passive_plan(m))
    if scalar:
        qadr = m.idx([m.jnt_qposadr[j] for j in scalar])
        dadr = m.idx([m.jnt_dofadr[j] for j in scalar])
        k = m.jnt_stiffness[m.idx(scalar)]
        frc = -k * (d.qpos[:, qadr] - m.qpos_spring[qadr])
        qfrc = qfrc.index_add(1, dadr, frc)
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
