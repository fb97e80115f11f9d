"""Forward kinematics and the other position-stage quantities, batched.

Counterpart of ``dm_control_tpu/physics/kinematics.py``: body, geom and
site frames; subtree centres of mass; CoM-centred motion subspaces (cdof);
body velocities; point jacobians.  The body tree is static, so the loops
below run over tree levels and joint-type groups, never over environments:
every tensor carries the batch ``B`` first.

Subtree and ancestor sums are masked matmuls over the static tree (the
JAX package's float32 path); they sum in another order than MuJoCo's
per-level sweep, which moves float64 results by rounding only.
"""

from __future__ import annotations

import torch

from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import (
    Data, JointType, Model, WrapType, body_subtree_mask, dof_before_mask,
)


def _fk_structure(m: Model):
    """Static FK schedule: per tree level the bodies, their parents, and
    per joint slot a dict type -> (rows within the level, joint ids)."""
    levels = []
    for level in m.body_tree_levels:
        bodies = list(level)
        parents = [m.body_parentid[b] for b in bodies]
        max_j = max((m.body_jntnum[b] for b in bodies), default=0)
        slots = []
        for k in range(max_j):
            groups = {}
            for row, b in enumerate(bodies):
                if m.body_jntnum[b] > k:
                    jid = m.body_jntadr[b] + k
                    rows, jids = groups.setdefault(m.jnt_type[jid], ([], []))
                    rows.append(row)
                    jids.append(jid)
            slots.append(groups)
        levels.append((bodies, parents, slots))
    return levels


def kinematics(m: Model, d: Data) -> Data:
    """mj_kinematics: xpos/xquat/xmat and geom/site frames, level by
    level, each joint type of a level as one batched group."""
    qpos = d.qpos
    B = qpos.shape[0]
    xpos = qpos.new_zeros(B, m.nbody, 3)
    xquat = qpos.new_zeros(B, m.nbody, 4)
    xquat[..., 0] = 1.0
    xanchor = qpos.new_zeros(B, m.njnt, 3)
    xaxis = qpos.new_zeros(B, m.njnt, 3)

    for bodies, parents, slots in m.cached("fk", lambda: _fk_structure(m)):
        bidx = m.idx(bodies)
        pq = xquat[:, m.idx(parents)]
        # body_pos and body_quat: (nbody, .) or (B, nbody, .) under a diff
        pos = xpos[:, m.idx(parents)] + mx.rotate(
            m.body_pos[..., bidx, :], pq)
        quat = mx.quat_mul(pq, m.body_quat[..., bidx, :])
        for groups in slots:
            for jtype, (rows, jids) in groups.items():
                r = m.idx(rows)
                j = m.idx(jids)
                qadr = [m.jnt_qposadr[x] for x in jids]
                jpos = m.jnt_pos[j]
                jaxn = m.jnt_axis[j]
                qsel = quat[:, r]
                psel = pos[:, r]
                if jtype == int(JointType.FREE):
                    newp = qpos[:, m.idx([[a + k for k in range(3)]
                                          for a in qadr])]
                    newq = mx.normalize(qpos[:, m.idx(
                        [[a + 3 + k for k in range(4)] for a in qadr])]
                        .reshape(B, len(jids), 4))
                    newp = newp.reshape(B, len(jids), 3)
                    anchor = newp
                elif jtype == int(JointType.BALL):
                    anchor = psel + mx.rotate(jpos, qsel)
                    qloc = mx.normalize(qpos[:, m.idx(
                        [[a + k for k in range(4)] for a in qadr])]
                        .reshape(B, len(jids), 4))
                    newq = mx.quat_mul(qsel, qloc)
                    newp = anchor - mx.rotate(jpos, newq)
                elif jtype == int(JointType.SLIDE):
                    qa = m.idx(qadr)
                    axis_w = mx.rotate(jaxn, qsel)
                    newp = psel + axis_w * (qpos[:, qa]
                                            - m.qpos0[qa]).unsqueeze(-1)
                    newq = qsel
                    anchor = newp + mx.rotate(jpos, qsel)
                else:  # HINGE
                    qa = m.idx(qadr)
                    anchor = psel + mx.rotate(jpos, qsel)
                    angle = qpos[:, qa] - m.qpos0[qa]
                    newq = mx.quat_mul(qsel, mx.axis_angle_to_quat(jaxn,
                                                                   angle))
                    newp = anchor - mx.rotate(jpos, newq)
                pos[:, r] = newp
                quat[:, r] = newq
                xanchor[:, j] = anchor
                xaxis[:, j] = mx.rotate(
                    jaxn, qsel if jtype == int(JointType.SLIDE) else newq)
        xpos[:, bidx] = pos
        xquat[:, bidx] = quat
    xmat = mx.quat_to_mat(xquat)

    xipos = xpos + mx.mat_vec(xmat, m.body_ipos)
    ximat = xmat @ mx.quat_to_mat(m.body_iquat)

    # geom_pos and site_pos are (n, 3), or (B, n, 3) under a per-episode
    # diff
    gb = m.idx(m.geom_bodyid)
    geom_xpos = xpos[:, gb] + mx.mat_vec(xmat[:, gb], m.geom_pos)
    geom_xmat = xmat[:, gb] @ mx.quat_to_mat(m.geom_quat)

    sb = m.idx(m.site_bodyid)
    site_xpos = xpos[:, sb] + mx.mat_vec(xmat[:, sb], m.site_pos)
    site_xmat = xmat[:, sb] @ mx.quat_to_mat(m.site_quat)

    return d.replace(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
        geom_xpos=geom_xpos, geom_xmat=geom_xmat,
        site_xpos=site_xpos, site_xmat=site_xmat,
        jnt_xanchor=xanchor, jnt_xaxis=xaxis)


def _cdof_groups(m: Model):
    """Per joint type: (joint ids, their dof addresses)."""
    groups = {}
    for jid in range(m.njnt):
        jids, dofs = groups.setdefault(m.jnt_type[jid], ([], []))
        jids.append(jid)
        dofs.append(m.jnt_dofadr[jid])
    return groups


def com_pos(m: Model, d: Data) -> Data:
    """mj_comPos: subtree CoM, CoM-centred body inertias, dof subspaces."""
    B = d.qpos.shape[0]
    weighted = m.body_mass.unsqueeze(-1) * d.xipos
    subtree_com = (body_subtree_mask(m) @ weighted) / torch.clamp(
        m.body_subtreemass.unsqueeze(-1), min=1e-15)

    rootx = subtree_com[:, m.idx(m.body_rootid)]
    cinert = mx.inert_from_body(m.body_mass, m.body_inertia,
                                d.xipos - rootx, d.ximat)

    cdof = d.qpos.new_zeros(B, m.nv, 6)
    for jtype, (jids, dofs) in m.cached("cdof", lambda: _cdof_groups(m)
                                        ).items():
        bodies = [m.jnt_bodyid[j] for j in jids]
        com = subtree_com[:, m.idx([m.body_rootid[b] for b in bodies])]
        anchor = d.jnt_xanchor[:, m.idx(jids)]
        if jtype in (int(JointType.FREE), int(JointType.BALL)):
            # rotational dofs about the body's own axes (columns of xmat)
            ax = d.xmat[:, m.idx(bodies)].transpose(-1, -2)  # (B, J, 3, 3)
            rot = torch.cat([ax, mx.cross(
                ax, (com - anchor).unsqueeze(-2))], dim=-1)
            first = 3 if jtype == int(JointType.FREE) else 0
            cols = m.idx([[a + first + k for k in range(3)] for a in dofs])
            cdof[:, cols] = rot.reshape(rot.shape[0], -1, 6)
            if jtype == int(JointType.FREE):
                trans = torch.zeros(3, 6, dtype=cdof.dtype,
                                    device=cdof.device)
                trans[:, 3:] = torch.eye(3, dtype=cdof.dtype,
                                         device=cdof.device)
                cdof[:, m.idx([[a + k for k in range(3)] for a in dofs])] = \
                    trans.repeat(len(dofs), 1)
        elif jtype == int(JointType.SLIDE):
            ax = d.jnt_xaxis[:, m.idx(jids)]
            cdof[:, m.idx(dofs)] = torch.cat([torch.zeros_like(ax), ax], -1)
        else:  # HINGE
            ax = d.jnt_xaxis[:, m.idx(jids)]
            cdof[:, m.idx(dofs)] = torch.cat([ax, mx.cross(ax, com - anchor)],
                                             dim=-1)
    return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def com_vel(m: Model, d: Data) -> Data:
    """mj_comVel: body spatial velocities and cdof time derivatives.

    cvel[b] sums cdof_j qvel_j over b's chain dofs; cdof_dot[k] is the
    velocity MuJoCo has accumulated when its sweep reaches dof k, crossed
    with cdof[k] (both as static-mask matmuls)."""
    per_dof = d.cdof * d.qvel.unsqueeze(-1)  # (B, nv, 6)
    cvel = m.body_chain_mask @ per_dof
    before, rotflag = dof_before_mask(m)
    cdof_dot = mx.motion_cross(before @ per_dof, d.cdof) \
        * rotflag.unsqueeze(-1)
    return d.replace(cvel=cvel, cdof_dot=cdof_dot)


def jac(m: Model, d: Data, point, bodyid: int):
    """mj_jac: translational and rotational Jacobians (B, 3, nv) of the
    world point ``point`` (B, 3) on body ``bodyid``."""
    jacp, jacr = jac_points(m, d, point.unsqueeze(1), [bodyid])
    return jacp[:, 0], jacr[:, 0]


def jac_site(m: Model, d: Data, siteid: int):
    """mj_jacSite: the Jacobians (B, 3, nv) of a site."""
    return jac(m, d, d.site_xpos[:, siteid], m.site_bodyid[siteid])


def jac_points(m: Model, d: Data, points, bodyids):
    """mj_jac over K world points: (jacp, jacr), each (B, K, 3, nv).
    ``points`` is (B, K, 3); ``bodyids`` is a sequence of K static body
    ids, or a (B, K) integer tensor of each environment's own (contact
    compaction selects the contacts per environment)."""
    if isinstance(bodyids, torch.Tensor):
        roots = m.cached("body_rootid", lambda: m.idx(m.body_rootid))
        mask = m.body_chain_mask[bodyids]  # (B, K, nv)
        com = torch.gather(d.subtree_com, 1, roots[bodyids].unsqueeze(
            -1).expand(*bodyids.shape, 3))
    else:
        mask = m.body_chain_mask[m.idx(bodyids)]  # (K, nv)
        com = d.subtree_com[:, m.idx([m.body_rootid[b] for b in bodyids])]
    offset = (points - com).unsqueeze(-2)  # (B, K, 1, 3)
    ang = d.cdof[:, None, :, :3]  # (B, 1, nv, 3)
    lin = d.cdof[:, None, :, 3:]
    jacp = (lin + mx.cross(ang, offset)) * mask.unsqueeze(-1)
    jacr = ang * mask.unsqueeze(-1)
    return jacp.transpose(-1, -2), jacr.transpose(-1, -2)


def _tendon_plan(m: Model):
    """Static tendon structure.  Fixed tendons (every wrap a joint): the
    wrap ids with their qpos and dof addresses, and 0/1 matrices
    wrap -> tendon and wrap -> dof.  Spatial tendons (every wrap a site):
    the straight segments between consecutive sites, their bodies, and a
    0/1 matrix segment -> tendon."""
    wraps, wrap_tendon, seg_sites, seg_tendon = [], [], [], []
    for t in range(m.ntendon):
        adr, num = m.tendon_adr[t], m.tendon_num[t]
        wtypes = set(m.wrap_type[adr:adr + num])
        if wtypes == {int(WrapType.JOINT)}:
            wraps += range(adr, adr + num)
            wrap_tendon += [t] * num
        elif wtypes == {int(WrapType.SITE)}:
            sites = m.wrap_objid[adr:adr + num]
            seg_sites += zip(sites[:-1], sites[1:])
            seg_tendon += [t] * (num - 1)
        else:
            raise NotImplementedError(
                f"tendon {t}: wrapping around geoms and pulleys is not "
                f"ported (the JAX package has fixed tendons and straight "
                f"site-to-site segments only)")

    def onehot(cols, ncol):
        mat = torch.zeros(len(cols), ncol, dtype=m.dtype, device=m.device)
        mat[torch.arange(len(cols), device=m.device), m.idx(cols)] = 1
        return mat

    joints = [m.wrap_objid[k] for k in wraps]
    dadr = [m.jnt_dofadr[j] for j in joints]
    return dict(
        wraps=wraps, qadr=[m.jnt_qposadr[j] for j in joints],
        wrap_tendon=onehot(wrap_tendon, m.ntendon),
        wrap_dof=onehot(dadr, m.nv),
        site0=[s[0] for s in seg_sites], site1=[s[1] for s in seg_sites],
        seg_tendon=onehot(seg_tendon, m.ntendon))


def tendon(m: Model, d: Data) -> Data:
    """mj_tendon: lengths (B, ntendon) and moment arms (B, ntendon, nv) of
    fixed and spatial tendons.  ``m.wrap_prm`` is (nwrap,), or (B, nwrap)
    under a per-episode diff."""
    if m.ntendon == 0:
        return d
    plan = m.cached("tendon", lambda: _tendon_plan(m))
    B = d.qpos.shape[0]
    length = d.qpos.new_zeros(B, m.ntendon)
    moment = d.qpos.new_zeros(B, m.ntendon, m.nv)
    if plan["wraps"]:
        coef = m.wrap_prm[..., m.idx(plan["wraps"])].expand(B, -1)
        length = length + (coef * d.qpos[:, m.idx(plan["qadr"])]) \
            @ plan["wrap_tendon"]
        moment = moment + torch.einsum("bk,kt,kv->btv", coef,
                                       plan["wrap_tendon"], plan["wrap_dof"])
    if plan["site0"]:
        s0, s1 = plan["site0"], plan["site1"]
        p0, p1 = d.site_xpos[:, m.idx(s0)], d.site_xpos[:, m.idx(s1)]
        diff = p1 - p0
        seg = mx.norm(diff)
        dirv = diff / torch.clamp(seg, min=1e-15).unsqueeze(-1)
        jac0, _ = jac_points(m, d, p0, [m.site_bodyid[s] for s in s0])
        jac1, _ = jac_points(m, d, p1, [m.site_bodyid[s] for s in s1])
        length = length + seg @ plan["seg_tendon"]
        moment = moment + torch.einsum(
            "bki,bkiv,kt->btv", dirv, jac1 - jac0, plan["seg_tendon"])
    return d.replace(ten_length=length, ten_moment=moment)


def tendon_velocity(m: Model, d: Data) -> Data:
    if m.ntendon == 0:
        return d
    return d.replace(ten_velocity=torch.einsum("btv,bv->bt", d.ten_moment,
                                               d.qvel))
