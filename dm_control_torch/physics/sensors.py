"""Sensor evaluation (mj_sensorPos/Vel/Acc), batched.

Counterpart of ``dm_control_tpu/physics/sensors.py``, for every sensor
type the JAX package computes: joint position and velocity (of a
hinge/slide joint), ball-joint quaternion and angular velocity, tendon and
actuator position and velocity, touch, accelerometer, velocimeter, gyro,
magnetometer, force, torque, rangefinder, frame position, orientation,
axes, linear and angular velocity and acceleration, subtree centre of
mass, subtree linear velocity and angular momentum.  Sensors of one type
are evaluated together and written into ``sensordata`` at their static
addresses.  Any other type raises ``NotImplementedError``: the JAX package
leaves its ``sensordata`` at 0 (ACTUATORFRC among them).
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import (
    Data, GeomType, JointType, Model, ObjType, SensorType, body_ancestor_mask,
    body_dof_mask, body_subtree_mask,
)

_S = SensorType
_FRAME_AXIS = {_S.FRAMEXAXIS: 0, _S.FRAMEYAXIS: 1, _S.FRAMEZAXIS: 2}
#: the velocity of a frame's point: the angular or the linear half of its
#: [ang, lin] 6D motion, in world axes
_FRAME_VEL = {_S.FRAMEANGVEL: slice(0, 3), _S.FRAMELINVEL: slice(3, 6)}
#: the same of its acceleration
_FRAME_ACC = {_S.FRAMEANGACC, _S.FRAMELINACC}
#: types whose object is any framed object or a body, not only a site
_ANY_OBJECT = {_S.FRAMEPOS, _S.FRAMEQUAT, _S.SUBTREECOM, _S.SUBTREELINVEL,
               _S.SUBTREEANGMOM, *_FRAME_AXIS, *_FRAME_VEL, *_FRAME_ACC}
#: types whose object is a hinge/slide joint, or a ball joint
_OF_JOINT = {_S.JOINTPOS, _S.JOINTVEL}
_OF_BALL = {_S.BALLQUAT, _S.BALLANGVEL}
#: types whose object is a tendon or an actuator
_OF_OTHER = {_S.TENDONPOS, _S.TENDONVEL, _S.ACTUATORPOS, _S.ACTUATORVEL}
_PORTED = {_S.TOUCH, _S.ACCELEROMETER, _S.VELOCIMETER, _S.GYRO,
           _S.MAGNETOMETER, _S.FORCE, _S.TORQUE, _S.RANGEFINDER,
           *_ANY_OBJECT, *_OF_JOINT, *_OF_BALL, *_OF_OTHER}
#: the acceleration-stage types
_ACC = {_S.TOUCH, _S.ACCELEROMETER, _S.FORCE, _S.TORQUE, *_FRAME_ACC}


def _by_type(m: Model):
    """sensor type -> list of sensor ids; checks every type is ported."""
    groups = {}
    for s in range(m.nsensor):
        stype = _S(m.sensor_type[s])
        if stype not in _PORTED:
            raise NotImplementedError(
                f"sensor {s}: type {stype.name} has no computation in the "
                f"JAX package, whose sensordata stays 0 for it; the port "
                f"refuses it instead of reporting 0")
        if stype in _OF_JOINT | _OF_BALL:
            jtype = m.jnt_type[m.sensor_objid[s]]
            allowed = ((int(JointType.HINGE), int(JointType.SLIDE))
                       if stype in _OF_JOINT else (int(JointType.BALL),))
            if jtype not in allowed:
                raise NotImplementedError(
                    f"sensor {s}: {stype.name} of a {JointType(jtype).name} "
                    f"joint")
        elif stype not in _ANY_OBJECT | _OF_OTHER and \
                m.sensor_objtype[s] != int(ObjType.SITE):
            raise NotImplementedError(
                f"sensor {s}: only site-attached {stype.name} is ported")
        groups.setdefault(stype, []).append(s)
    return groups


def _groups(m: Model):
    return m.cached("sensors", lambda: _by_type(m))


def _put(m: Model, out, sensors, val):
    """Writes val (B, S, dim) at the addresses of ``sensors``."""
    dim = val.shape[-1]
    cols = m.idx([[m.sensor_adr[s] + k for k in range(dim)]
                  for s in sensors])
    out[:, cols] = val.reshape(val.shape[0], -1)


def _site_frame(m: Model, d: Data, sensors):
    """Site position and frame of each sensor, its body, and the offset
    from that body's root subtree CoM."""
    sites = [m.sensor_objid[s] for s in sensors]
    bodies = [m.site_bodyid[i] for i in sites]
    pos = d.site_xpos[:, m.idx(sites)]
    mat = d.site_xmat[:, m.idx(sites)]
    offset = pos - d.subtree_com[:, m.idx([m.body_rootid[b]
                                           for b in bodies])]
    return bodies, mat, offset


def _of_objects(m: Model, sensors, site, body, geom):
    """The rows (B, S, ...) of the sensors' objects, which are sites,
    bodies or geoms, out of the three per-kind tensors."""
    offset = {int(ObjType.SITE): 0, int(ObjType.BODY): m.nsite,
              int(ObjType.XBODY): m.nsite, int(ObjType.GEOM):
              m.nsite + m.nbody}
    for s in sensors:
        if m.sensor_objtype[s] not in offset:
            raise NotImplementedError(
                f"sensor {s}: frame of object type {m.sensor_objtype[s]}")
    at = m.idx([offset[m.sensor_objtype[s]] + m.sensor_objid[s]
                for s in sensors])
    return torch.cat([site, body, geom], dim=1)[:, at]


def _object_bodies(m: Model, sensors):
    """The body of each sensor's object (a site's or a geom's, or the body
    itself) and the root of that body's tree."""
    def build():
        bodies = []
        for s in sensors:
            kind, i = m.sensor_objtype[s], m.sensor_objid[s]
            bodies.append(m.site_bodyid[i] if kind == int(ObjType.SITE)
                          else m.geom_bodyid[i] if kind == int(ObjType.GEOM)
                          else i)
        return m.idx(bodies), m.idx([m.body_rootid[b] for b in bodies])
    return m.cached(("object_bodies", tuple(sensors)), build)


def sensor_pos(m: Model, d: Data) -> Data:
    if m.nsensor == 0:
        return d
    groups = _groups(m)
    if not any(t in groups for t in (
            _S.JOINTPOS, _S.BALLQUAT, _S.TENDONPOS, _S.ACTUATORPOS,
            _S.MAGNETOMETER, _S.FRAMEPOS, _S.FRAMEQUAT, _S.SUBTREECOM,
            _S.RANGEFINDER, *_FRAME_AXIS)):
        return d
    out = d.sensordata.clone()
    for stype, sensors in groups.items():
        objs = [m.sensor_objid[s] for s in sensors]
        if stype == _S.JOINTPOS:
            _put(m, out, sensors, d.qpos[:, m.idx(
                [m.jnt_qposadr[j] for j in objs])].unsqueeze(-1))
        elif stype == _S.BALLQUAT:
            _put(m, out, sensors, mx.normalize(d.qpos[:, m.idx(
                [[m.jnt_qposadr[j] + k for k in range(4)] for j in objs])
            ].reshape(d.qpos.shape[0], -1, 4)))
        elif stype == _S.TENDONPOS:
            _put(m, out, sensors, d.ten_length[:, m.idx(objs)].unsqueeze(-1))
        elif stype == _S.ACTUATORPOS:
            _put(m, out, sensors,
                 d.actuator_length[:, m.idx(objs)].unsqueeze(-1))
        elif stype == _S.MAGNETOMETER:
            _put(m, out, sensors, mx.mat_t_vec(
                d.site_xmat[:, m.idx(objs)], m.opt.magnetic))
        elif stype == _S.FRAMEPOS:
            _put(m, out, sensors, _of_objects(
                m, sensors, d.site_xpos, d.xpos, d.geom_xpos))
        elif stype == _S.FRAMEQUAT:
            _put(m, out, sensors, mx.mat_to_quat(_of_objects(
                m, sensors, d.site_xmat, d.xmat, d.geom_xmat)))
        elif stype in _FRAME_AXIS:
            mat = _of_objects(m, sensors, d.site_xmat, d.xmat, d.geom_xmat)
            _put(m, out, sensors, mat[..., _FRAME_AXIS[stype]])
        elif stype == _S.SUBTREECOM:
            _put(m, out, sensors, d.subtree_com[:, m.idx(
                [m.sensor_objid[s] for s in sensors])])
        elif stype == _S.RANGEFINDER:
            _put(m, out, sensors, _rangefinder(m, d, sensors).unsqueeze(-1))
    return d.replace(sensordata=out)


def _rangefinder(m: Model, d: Data, sensors):
    """Distances (B, S) along each site's +z to the nearest plane or
    sphere that is not on the site's own body, -1 for a miss; every ray
    against every such geom at once.  Other geom types (a heightfield
    too) are not seen, as in the JAX package."""
    sites = [m.sensor_objid[s] for s in sensors]
    sidx = m.idx(sites)
    origin = d.site_xpos[:, sidx].unsqueeze(2)  # (B, S, 1, 3)
    direction = d.site_xmat[:, sidx][..., 2].unsqueeze(2)
    inf = float("inf")
    best = d.qpos.new_full((d.qpos.shape[0], len(sites)), inf)

    def nearest(gtype):
        """(geom ids, (S, G) mask of the geoms off each site's body)."""
        geoms = [g for g in range(m.ngeom) if m.geom_type[g] == int(gtype)]
        sb = np.array([m.site_bodyid[i] for i in sites])[:, None]
        gb = np.array([m.geom_bodyid[g] for g in geoms])[None]
        return geoms, torch.as_tensor(sb != gb, device=m.device)

    planes, seen = m.cached(("rangefinder_planes", tuple(sensors)),
                            lambda: nearest(GeomType.PLANE))
    if planes:
        g = m.idx(planes)
        n = d.geom_xmat[:, g][..., 2].unsqueeze(1)  # (B, 1, G, 3)
        denom = mx.dot(n, direction)
        t = mx.dot(n, d.geom_xpos[:, g].unsqueeze(1) - origin) / torch.where(
            torch.abs(denom) < 1e-12, torch.full_like(denom, inf), denom)
        t = torch.where((t > 0) & seen, t, torch.full_like(t, inf))
        best = torch.minimum(best, t.min(-1).values)
    spheres, seen = m.cached(("rangefinder_spheres", tuple(sensors)),
                             lambda: nearest(GeomType.SPHERE))
    if spheres:
        g = m.idx(spheres)
        oc = origin - d.geom_xpos[:, g].unsqueeze(1)  # (B, S, G, 3)
        b = mx.dot(oc, direction)
        disc = b * b - (mx.dot(oc, oc) - m.geom_size[g, 0] ** 2)
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        t = torch.where((disc > 0) & (t > 0) & seen, t,
                        torch.full_like(t, inf))
        best = torch.minimum(best, t.min(-1).values)
    return torch.where(torch.isinf(best), -torch.ones_like(best), best)


def sensor_vel(m: Model, d: Data) -> Data:
    if m.nsensor == 0:
        return d
    out = d.sensordata.clone()
    subtree = None
    for stype, sensors in _groups(m).items():
        objs = [m.sensor_objid[s] for s in sensors]
        if stype == _S.JOINTVEL:
            _put(m, out, sensors, d.qvel[:, m.idx(
                [m.jnt_dofadr[j] for j in objs])].unsqueeze(-1))
        elif stype == _S.BALLANGVEL:
            _put(m, out, sensors, d.qvel[:, m.idx(
                [[m.jnt_dofadr[j] + k for k in range(3)] for j in objs])
            ].reshape(d.qvel.shape[0], -1, 3))
        elif stype == _S.TENDONVEL:
            _put(m, out, sensors,
                 d.ten_velocity[:, m.idx(objs)].unsqueeze(-1))
        elif stype == _S.ACTUATORVEL:
            _put(m, out, sensors,
                 d.actuator_velocity[:, m.idx(objs)].unsqueeze(-1))
        elif stype in (_S.GYRO, _S.VELOCIMETER):
            bodies, mat, offset = _site_frame(m, d, sensors)
            vel = mx.transform_motion(d.cvel[:, m.idx(bodies)], offset)
            part = vel[..., :3] if stype == _S.GYRO else vel[..., 3:]
            _put(m, out, sensors, mx.mat_t_vec(mat, part))
        elif stype in _FRAME_VEL:
            # the velocity of the object's point, carried by its body,
            # taken about the root subtree's CoM, in world axes
            bodies, roots = _object_bodies(m, sensors)
            pos = _of_objects(m, sensors, d.site_xpos, d.xpos, d.geom_xpos)
            vel = mx.transform_motion(d.cvel[:, bodies],
                                      pos - d.subtree_com[:, roots])
            _put(m, out, sensors, vel[..., _FRAME_VEL[stype]])
        elif stype in (_S.SUBTREELINVEL, _S.SUBTREEANGMOM):
            if subtree is None:
                subtree = _subtree_vel(m, d, [
                    m.sensor_objid[s]
                    for s in _groups(m).get(_S.SUBTREEANGMOM, ())])
            linvel, angmom = subtree
            _put(m, out, sensors, angmom if stype == _S.SUBTREEANGMOM
                 else linvel[:, m.idx([m.sensor_objid[s] for s in sensors])])
    return d.replace(sensordata=out)


def sensor_acc(m: Model, d: Data) -> Data:
    """Acceleration/force sensors; needs the post-constraint qacc."""
    groups = _groups(m) if m.nsensor else {}
    if not any(t in groups for t in _ACC):
        return d
    cacc, cfrc_int = _rne_postconstraint(m, d)
    out = d.sensordata.clone()
    for stype, sensors in groups.items():
        if stype == _S.TOUCH:
            _put(m, out, sensors, _touch(m, d, sensors).unsqueeze(-1))
        elif stype == _S.ACCELEROMETER:
            bodies, mat, offset = _site_frame(m, d, sensors)
            b = m.idx(bodies)
            acc6 = mx.transform_motion(cacc[:, b], offset)
            vel6 = mx.transform_motion(d.cvel[:, b], offset)
            lin = acc6[..., 3:] + mx.cross(vel6[..., :3], vel6[..., 3:])
            _put(m, out, sensors, mx.mat_t_vec(mat, lin))
        elif stype in _FRAME_ACC:
            # the acceleration of the object's point about its root
            # subtree's CoM, in world axes; the linear one with the
            # centripetal term and gravity added back, as in the JAX
            # package
            bodies, roots = _object_bodies(m, sensors)
            pos = _of_objects(m, sensors, d.site_xpos, d.xpos, d.geom_xpos)
            offset = pos - d.subtree_com[:, roots]
            acc6 = mx.transform_motion(cacc[:, bodies], offset)
            if stype == _S.FRAMEANGACC:
                _put(m, out, sensors, acc6[..., :3])
            else:
                vel6 = mx.transform_motion(d.cvel[:, bodies], offset)
                lin = acc6[..., 3:] + mx.cross(vel6[..., :3], vel6[..., 3:])
                _put(m, out, sensors, lin + m.opt.gravity)
        elif stype in (_S.FORCE, _S.TORQUE):
            bodies, mat, offset = _site_frame(m, d, sensors)
            fr = mx.transform_force(cfrc_int[:, m.idx(bodies)], offset)
            part = fr[..., 3:] if stype == _S.FORCE else fr[..., :3]
            _put(m, out, sensors, mx.mat_t_vec(mat, part))
    return d.replace(sensordata=out)


def _touch(m: Model, d: Data, sensors):
    """Touch values (B, S): normal force of the contacts whose position
    lies inside the sensor's site volume and that involve its body."""
    con = d.contact
    if not con.dim:
        return d.qpos.new_zeros(d.qpos.shape[0], len(sensors))
    sids = [m.sensor_objid[s] for s in sensors]

    def touches_body():  # (S, C): the contact involves the site's body
        sb = np.array([m.site_bodyid[i] for i in sids])[:, None]
        cb1 = np.array([m.geom_bodyid[g] for g in con.geom1])[None]
        cb2 = np.array([m.geom_bodyid[g] for g in con.geom2])[None]
        return torch.as_tensor((sb == cb1) | (sb == cb2), device=m.device)

    body_mask = m.cached(("touch_body", tuple(sensors)), touches_body)
    sidx = m.idx(sids)
    smat = d.site_xmat[:, sidx]  # (B, S, 3, 3)
    rel = con.pos[:, None] - d.site_xpos[:, sidx, None]  # (B, S, C, 3)
    p = torch.einsum("bsij,bsci->bscj", smat, rel)
    # (S, 1, 3), or (B, S, 1, 3) under a per-episode diff
    size = m.site_size[..., sidx, :].unsqueeze(-2)
    st = m.cached(("touch_type", tuple(sensors)), lambda: torch.tensor(
        [m.site_type[i] for i in sids], device=m.device)[:, None])

    r2 = size[..., 0] ** 2
    sphere = torch.sum(p * p, -1) <= r2
    z = torch.clamp(p[..., 2], -size[..., 1], size[..., 1])
    capsule = (p[..., 0] ** 2 + p[..., 1] ** 2 + (p[..., 2] - z) ** 2) <= r2
    ellipsoid = torch.sum((p / torch.clamp(size, min=1e-15)) ** 2, -1) <= 1.0
    cylinder = ((p[..., 0] ** 2 + p[..., 1] ** 2 <= r2)
                & (torch.abs(p[..., 2]) <= size[..., 1]))
    box = torch.all(torch.abs(p) <= size, -1)
    inside = torch.where(st == 2, sphere, torch.where(
        st == 3, capsule, torch.where(st == 4, ellipsoid, torch.where(
            st == 5, cylinder, box))))
    force = torch.clamp(d.contact_force, min=0.0)[:, None, :]  # (B, 1, C)
    return torch.sum(torch.where(body_mask & inside, force,
                                 torch.zeros_like(force)), dim=-1)


def _subtree_vel(m: Model, d: Data, bodies=()):
    """mj_subtreeVel: the subtree CoM linear velocity of every body
    (B, nbody, 3), and the angular momentum (B, len(bodies), 3) of the
    subtrees of ``bodies`` about their CoMs (None without ``bodies``):

        L_b = sum_{i in subtree(b)} I_i w_i + m_i (r_i - c_b) x (v_i - v_b)

    with I_i w_i in world axes; membership is ``body_subtree_mask``."""
    root = m.idx(m.body_rootid)
    vel6 = mx.transform_motion(d.cvel, d.xipos - d.subtree_com[:, root])
    ang, lin = vel6[..., :3], vel6[..., 3:]
    member = body_subtree_mask(m)
    mom = m.body_mass.unsqueeze(-1) * lin
    linvel = (member @ mom) / torch.clamp(
        m.body_subtreemass.unsqueeze(-1), min=1e-15)
    if not bodies:
        return linvel, None
    iw = mx.mat_vec(d.ximat, m.body_inertia * mx.mat_t_vec(d.ximat, ang))
    b = m.idx(bodies)
    sub = member[b]  # (S, nbody)
    r = d.xipos.unsqueeze(1) - d.subtree_com[:, b].unsqueeze(2)
    dv = lin.unsqueeze(1) - linvel[:, b].unsqueeze(2)  # (B, S, nbody, 3)
    cross = mx.cross(r, dv) * m.body_mass.unsqueeze(-1)
    angmom = sub @ iw + torch.sum(sub.unsqueeze(-1) * cross, dim=2)
    return linvel, angmom


def _rne_postconstraint(m: Model, d: Data):
    """mj_rnePostConstraint: cacc and cfrc_int with the final qacc and
    the contact and applied forces."""
    cacc0 = torch.cat([torch.zeros_like(m.opt.gravity), -m.opt.gravity])
    per_dof = (d.cdof_dot * d.qvel.unsqueeze(-1)
               + d.cdof * d.qacc.unsqueeze(-1))
    cacc = cacc0 + body_ancestor_mask(m) @ (body_dof_mask(m) @ per_dof)
    cfrc_body = mx.inert_mul(d.cinert, cacc) + mx.force_cross(
        d.cvel, mx.inert_mul(d.cinert, d.cvel))
    cfrc_int = body_subtree_mask(m) @ (cfrc_body - _cfrc_ext(m, d))
    return cacc, cfrc_int


def _contact_incidence(m: Model, con):
    """(nbody, ncon) signed incidence: +1 where the contact's second geom
    is on the body, -1 where its first is."""
    inc = torch.zeros(m.nbody, len(con.dim), dtype=m.dtype)
    for c, (g1, g2) in enumerate(zip(con.geom1, con.geom2)):
        inc[m.geom_bodyid[g2], c] += 1.0
        inc[m.geom_bodyid[g1], c] -= 1.0
    return inc.to(m.device)


def _cfrc_ext(m: Model, d: Data):
    """External (contact + xfrc_applied) wrench per body at its root's
    subtree CoM, world axes."""
    root_com = d.subtree_com[:, m.idx(m.body_rootid)]
    con = d.contact
    cfrc_ext = torch.zeros_like(d.cinert[..., :6])
    if con.dim:
        wrench = d.contact_force_vec
        f_w = torch.einsum("bkij,bki->bkj", con.frame, wrench[..., :3])
        t_w = torch.einsum("bkij,bki->bkj", con.frame, wrench[..., 3:])
        inc = m.cached("contact_incidence",
                       lambda: _contact_incidence(m, con)).to(f_w.dtype)
        # torque about the world origin, then moved to each body's root
        # CoM: t + (pos - com) x f = (t + pos x f) - com x f
        trq0 = t_w + mx.cross(con.pos, f_w)
        frc = inc @ f_w  # (B, nbody, 3)
        trq = inc @ trq0 - mx.cross(root_com, frc)
        cfrc_ext = torch.cat([trq, frc], dim=-1)
    off = d.xipos - root_com
    xf = d.xfrc_applied
    trq = xf[..., 3:] + mx.cross(off, xf[..., :3])
    return cfrc_ext + torch.cat([trq, xf[..., :3]], dim=-1)
