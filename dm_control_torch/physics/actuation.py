"""Actuator transmission, activation dynamics and force generation,
batched.  Counterpart of ``dm_control_tpu/physics/actuation.py``: the
transmissions on a joint of any type, on a tendon and on a site, with no
activation dynamics or an integrator or a first-order filter."""

from __future__ import annotations

import torch

from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import (
    BiasType, Data, DisableBit, DynType, GainType, JointType, Model, TrnType,
)


def _transmission_plan(m: Model):
    """Static split of the actuators: on a hinge/slide joint (ids, qpos
    and dof addresses), on a tendon (ids, tendons), on a ball or a free
    joint (ids, dof addresses), on a site (ids, sites).  The moment rows
    of the joint actuators never change: on a hinge/slide joint gear[0]
    at its dof, on a ball joint gear[0:3] at its three dofs, on a free
    joint gear[0:6] at its six (the JAX package's world wrench)."""
    joint, tendon, ball, free, site = [], [], [], [], []
    for u in range(m.nu):
        trn = m.actuator_trntype[u]
        tid = m.actuator_trnid[u][0]
        if trn in (int(TrnType.JOINT), int(TrnType.JOINTINPARENT)):
            {int(JointType.SLIDE): joint, int(JointType.HINGE): joint,
             int(JointType.BALL): ball,
             int(JointType.FREE): free}[m.jnt_type[tid]].append(u)
        elif trn == int(TrnType.TENDON):
            tendon.append(u)
        elif trn == int(TrnType.SITE):
            site.append(u)
        else:
            raise NotImplementedError(
                f"actuator {u}: transmission {TrnType(trn).name} is not "
                f"ported (the JAX package has none)")
    jids = [m.actuator_trnid[u][0] for u in joint]
    dadr = [m.jnt_dofadr[j] for j in jids]
    moment = torch.zeros(m.nu, m.nv, dtype=m.dtype, device=m.device)
    moment[m.idx(joint), m.idx(dadr)] = m.actuator_gear[m.idx(joint), 0]
    for group, width in ((ball, 3), (free, 6)):
        for u in group:
            a = m.jnt_dofadr[m.actuator_trnid[u][0]]
            moment[u, a:a + width] = m.actuator_gear[u, :width]
    return dict(joint=joint, qadr=[m.jnt_qposadr[j] for j in jids],
                tendon=tendon, moment=moment,
                tendon_id=[m.actuator_trnid[u][0] for u in tendon],
                site=site, site_id=[m.actuator_trnid[u][0] for u in site],
                fixed=not (tendon or site))


def transmission(m: Model, d: Data) -> Data:
    """mj_transmission: actuator lengths and moment arms.  A ball, free or
    site transmission has length 0; a site's moment is its gear, a wrench
    in the site's frame, through the site's Jacobian."""
    if m.nu == 0:
        return d
    plan = m.cached("trn", lambda: _transmission_plan(m))
    B = d.qpos.shape[0]
    gear0 = m.actuator_gear[:, 0]
    moment = plan["moment"].expand(B, m.nu, m.nv)
    ju = m.idx(plan["joint"])
    if len(ju) == m.nu:
        return d.replace(
            actuator_length=gear0 * d.qpos[:, m.idx(plan["qadr"])],
            actuator_moment=moment)
    lengths = d.qpos.new_zeros(B, m.nu)
    lengths[:, ju] = gear0[ju] * d.qpos[:, m.idx(plan["qadr"])]
    if plan["fixed"]:
        return d.replace(actuator_length=lengths, actuator_moment=moment)
    moment = moment.clone()
    if plan["tendon"]:
        tu, tid = m.idx(plan["tendon"]), m.idx(plan["tendon_id"])
        lengths[:, tu] = gear0[tu] * d.ten_length[:, tid]
        moment[:, tu] = gear0[tu, None] * d.ten_moment[:, tid]
    if plan["site"]:
        from dm_control_torch.physics import kinematics as kin

        su, sid = m.idx(plan["site"]), m.idx(plan["site_id"])
        jacp, jacr = kin.jac_points(
            m, d, d.site_xpos[:, sid],
            [m.site_bodyid[s] for s in plan["site_id"]])
        frame = d.site_xmat[:, sid]
        gear = m.actuator_gear[su]
        force = mx.mat_vec(frame, gear[:, :3])
        torque = mx.mat_vec(frame, gear[:, 3:6])
        moment[:, su] = (torch.einsum("bkiv,bki->bkv", jacp, force)
                         + torch.einsum("bkiv,bki->bkv", jacr, torque))
    return d.replace(actuator_length=lengths, actuator_moment=moment)


def actuator_velocity(m: Model, d: Data) -> Data:
    if m.nu == 0:
        return d
    return d.replace(actuator_velocity=torch.einsum(
        "buv,bv->bu", d.actuator_moment, d.qvel))


def _activation_plan(m: Model):
    """Static activation structure, or None where no actuator has
    dynamics: the actuators with a state and their addresses in ``act``,
    which of them are filters, and the filters' time constants."""
    stateful = [u for u in range(m.nu)
                if m.actuator_dyntype[u] != int(DynType.NONE)]
    if not stateful:
        return None
    for u in stateful:
        if m.actuator_dyntype[u] not in (
                int(DynType.INTEGRATOR), int(DynType.FILTER),
                int(DynType.FILTEREXACT)):
            raise NotImplementedError(
                f"actuator {u}: muscle activation dynamics are not ported "
                f"(no suite model has them)")
    uidx = m.idx(stateful)
    return dict(
        u=uidx, adr=m.idx([m.actuator_actadr[u] for u in stateful]),
        is_filter=torch.tensor(
            [m.actuator_dyntype[u] != int(DynType.INTEGRATOR)
             for u in stateful], device=m.device),
        tau=torch.clamp(m.actuator_dynprm[uidx, 0], min=1e-15))


def fwd_actuation(m: Model, d: Data) -> Data:
    """mj_fwdActuation: activation derivatives, forces and generalized
    forces.  An actuator with dynamics takes its activation as input."""
    if m.nu == 0 or (m.opt.disableflags & DisableBit.ACTUATION):
        return d.replace(qfrc_actuator=torch.zeros_like(d.qvel),
                         actuator_force=torch.zeros_like(d.ctrl))
    m.cached("trn", lambda: _transmission_plan(m))
    ctrl = d.ctrl
    if not (m.opt.disableflags & DisableBit.CLAMPCTRL):
        limited = m.cached("ctrllimited", lambda: torch.tensor(
            m.actuator_ctrllimited, dtype=torch.bool, device=m.device))
        ctrl = torch.where(limited, torch.clamp(
            ctrl, m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]),
            ctrl)
    plan = m.cached("activation", lambda: _activation_plan(m))
    act_dot = torch.zeros_like(d.act)
    if plan is not None:
        act = d.act[:, plan["adr"]]
        cu = ctrl[:, plan["u"]]
        act_dot = act_dot.index_copy(1, plan["adr"], torch.where(
            plan["is_filter"], (cu - act) / plan["tau"], cu))
        ctrl = ctrl.index_copy(1, plan["u"], act)
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
    return d.replace(act_dot=act_dot, actuator_force=force,
                     qfrc_actuator=qfrc)
