"""Velocity-stage dynamics: RNE bias forces and passive forces, batched.
Counterpart of ``dm_control_tpu/physics/dynamics.py``."""

from __future__ import annotations

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
            "(ROADMAP A5: humanoid_CMU, dog and lqr)")
    fluid = bool(float(m.opt.density) != 0.0 or float(m.opt.viscosity) != 0.0
                 or np.any(m.opt.wind.cpu().numpy() != 0.0))
    if fluid:
        raise NotImplementedError(
            "fluid forces are not ported yet (ROADMAP A4: fish and "
            "swimmer)")
    return scalar


def passive(m: Model, d: Data) -> Data:
    """mj_passive: scalar-joint springs, joint dampers, and tendon springs
    (active outside ``tendon_lengthspring``'s deadband) and dampers."""
    qfrc = torch.zeros_like(d.qvel)
    if m.opt.disableflags & DisableBit.PASSIVE:
        return d.replace(qfrc_passive=qfrc)
    scalar = m.cached("passive", lambda: _passive_plan(m))
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
    return d.replace(qfrc_passive=qfrc)


def xfrc_accumulate(m: Model, d: Data):
    """Generalized force of the Cartesian wrenches ``xfrc_applied``
    ([force, torque] at each body's CoM)."""
    bodies = tuple(range(1, m.nbody))
    jacp, jacr = kin.jac_points(m, d, d.xipos[:, 1:], bodies)
    f = d.xfrc_applied[:, 1:]
    return (torch.einsum("bkiv,bki->bv", jacp, f[..., :3])
            + torch.einsum("bkiv,bki->bv", jacr, f[..., 3:]))
