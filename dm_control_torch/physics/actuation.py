"""Actuator transmission and force generation, batched.
Counterpart of ``dm_control_tpu/physics/actuation.py`` for actuators with
a joint transmission on scalar joints and no activation dynamics."""

from __future__ import annotations

import torch

from dm_control_torch.physics.model import (
    BiasType, Data, DisableBit, DynType, GainType, JointType, Model, TrnType,
)


def _scalar_joint_plan(m: Model):
    for u in range(m.nu):
        trn = m.actuator_trntype[u]
        jid = m.actuator_trnid[u][0]
        if trn not in (int(TrnType.JOINT), int(TrnType.JOINTINPARENT)) or \
                m.jnt_type[jid] not in (int(JointType.SLIDE),
                                        int(JointType.HINGE)):
            raise NotImplementedError(
                f"actuator {u}: only joint transmissions on hinge/slide "
                f"joints are ported (ROADMAP A: the other 18 domains)")
        if m.actuator_dyntype[u] != int(DynType.NONE):
            raise NotImplementedError(
                f"actuator {u}: activation dynamics are not ported yet "
                f"(ROADMAP A: the other 18 domains)")
    jids = [m.actuator_trnid[u][0] for u in range(m.nu)]
    return ([m.jnt_qposadr[j] for j in jids], [m.jnt_dofadr[j] for j in jids])


def transmission(m: Model, d: Data) -> Data:
    """mj_transmission: actuator lengths and moment arms."""
    if m.nu == 0:
        return d
    qadr, dadr = m.cached("trn", lambda: _scalar_joint_plan(m))
    gear0 = m.actuator_gear[:, 0]
    lengths = gear0 * d.qpos[:, m.idx(qadr)]

    def moment():
        mom = torch.zeros(m.nu, m.nv, dtype=m.dtype, device=m.device)
        mom[torch.arange(m.nu, device=m.device), m.idx(dadr)] = gear0
        return mom

    mom = m.cached("trn_moment", moment).to(d.qpos.dtype)
    return d.replace(actuator_length=lengths,
                     actuator_moment=mom.expand(d.qpos.shape[0], m.nu, m.nv))


def actuator_velocity(m: Model, d: Data) -> Data:
    if m.nu == 0:
        return d
    return d.replace(actuator_velocity=torch.einsum(
        "buv,bv->bu", d.actuator_moment, d.qvel))


def fwd_actuation(m: Model, d: Data) -> Data:
    """mj_fwdActuation: forces and generalized forces (no activations)."""
    if m.nu == 0 or (m.opt.disableflags & DisableBit.ACTUATION):
        return d.replace(qfrc_actuator=torch.zeros_like(d.qvel),
                         actuator_force=torch.zeros_like(d.ctrl))
    m.cached("trn", lambda: _scalar_joint_plan(m))
    ctrl = d.ctrl
    if not (m.opt.disableflags & DisableBit.CLAMPCTRL):
        limited = m.cached("ctrllimited", lambda: torch.tensor(
            m.actuator_ctrllimited, dtype=torch.bool, device=m.device))
        ctrl = torch.where(limited, torch.clamp(
            ctrl, m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]),
            ctrl)
    ln, vel = d.actuator_length, d.actuator_velocity
    gp, bp = m.actuator_gainprm, m.actuator_biasprm
    fixed = m.cached("gain_fixed", lambda: torch.tensor(
        [g == int(GainType.FIXED) for g in m.actuator_gaintype],
        device=m.device))
    gain = torch.where(fixed, gp[:, 0], gp[:, 0] + gp[:, 1] * ln
                       + gp[:, 2] * vel)
    nobias = m.cached("bias_none", lambda: torch.tensor(
        [b == int(BiasType.NONE) for b in m.actuator_biastype],
        device=m.device))
    bias = torch.where(nobias, torch.zeros_like(ln),
                       bp[:, 0] + bp[:, 1] * ln + bp[:, 2] * vel)
    force = gain * ctrl + bias
    flimited = m.cached("forcelimited", lambda: torch.tensor(
        m.actuator_forcelimited, dtype=torch.bool, device=m.device))
    force = torch.where(flimited, torch.clamp(
        force, m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1]),
        force)
    qfrc = torch.einsum("buv,bu->bv", d.actuator_moment, force)
    return d.replace(act_dot=torch.zeros_like(d.act), actuator_force=force,
                     qfrc_actuator=qfrc)
