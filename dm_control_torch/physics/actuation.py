"""Actuator transmission, activation dynamics and force generation,
batched.  Counterpart of ``dm_control_tpu/physics/actuation.py`` for
actuators with a transmission on a scalar joint or on a tendon, with no
activation dynamics or an integrator or a first-order filter."""

from __future__ import annotations

import torch

from dm_control_torch.physics.model import (
    BiasType, Data, DisableBit, DynType, GainType, JointType, Model, TrnType,
)


def _transmission_plan(m: Model):
    """Static split of the actuators into those on a hinge/slide joint
    (ids, qpos and dof addresses) and those on a tendon (ids, tendons)."""
    joint, tendon = [], []
    for u in range(m.nu):
        trn = m.actuator_trntype[u]
        tid = m.actuator_trnid[u][0]
        if trn in (int(TrnType.JOINT), int(TrnType.JOINTINPARENT)) and \
                m.jnt_type[tid] in (int(JointType.SLIDE),
                                    int(JointType.HINGE)):
            joint.append(u)
        elif trn == int(TrnType.TENDON):
            tendon.append(u)
        else:
            raise NotImplementedError(
                f"actuator {u}: only transmissions on hinge/slide joints "
                f"and on tendons are ported (ROADMAP A5: composer, "
                f"locomotion and manipulation)")
    jids = [m.actuator_trnid[u][0] for u in joint]
    dadr = [m.jnt_dofadr[j] for j in jids]
    # the joint actuators' rows of the moment never change
    moment = torch.zeros(m.nu, m.nv, dtype=m.dtype, device=m.device)
    moment[m.idx(joint), m.idx(dadr)] = m.actuator_gear[m.idx(joint), 0]
    return dict(joint=joint, qadr=[m.jnt_qposadr[j] for j in jids],
                tendon=tendon, moment=moment,
                tendon_id=[m.actuator_trnid[u][0] for u in tendon])


def transmission(m: Model, d: Data) -> Data:
    """mj_transmission: actuator lengths and moment arms."""
    if m.nu == 0:
        return d
    plan = m.cached("trn", lambda: _transmission_plan(m))
    B = d.qpos.shape[0]
    gear0 = m.actuator_gear[:, 0]
    moment = plan["moment"].expand(B, m.nu, m.nv)
    if not plan["tendon"]:
        return d.replace(
            actuator_length=gear0 * d.qpos[:, m.idx(plan["qadr"])],
            actuator_moment=moment)
    ju, tu, tid = (m.idx(plan[k]) for k in ("joint", "tendon", "tendon_id"))
    lengths = d.qpos.new_zeros(B, m.nu)
    lengths[:, ju] = gear0[ju] * d.qpos[:, m.idx(plan["qadr"])]
    lengths[:, tu] = gear0[tu] * d.ten_length[:, tid]
    moment = moment.clone()
    moment[:, tu] = gear0[tu, None] * d.ten_moment[:, tid]
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
