"""Quaternion, rotation and 6D spatial algebra for the batched engine.

Counterpart of ``dm_control_tpu/physics/mathx.py``, with the same
conventions (MuJoCo's):

- quaternions are ``(w, x, y, z)``, unit norm;
- rotation matrices are world-from-local;
- 6D motion vectors are ``[angular(3), linear(3)]``, force vectors
  ``[torque(3), force(3)]``;
- spatial inertias are 10-vectors ``[Ixx, Iyy, Izz, Ixy, Ixz, Iyz, m*c, m]``
  about a given origin.

Every function works over any leading dimensions and broadcasts them, so
a per-body constant ``(nbody, 3)`` combines with a batch ``(B, nbody, 3)``.
"""

from __future__ import annotations

import torch


def cross(a, b):
    """a x b over the last dimension, broadcasting the leading ones (the
    component formula of ``jnp.cross``)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def normalize(v, eps=1e-15):
    n = norm(v).unsqueeze(-1)
    return v / torch.clamp(n, min=eps)


def quat_mul(u, v):
    """Hamilton product u (x) v."""
    w1, x1, y1, z1 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    w2, x2, y2, z2 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def rotate(vec, quat):
    """Rotates ``vec`` by ``quat`` (world = R(quat) @ local)."""
    w = quat[..., :1]
    u = quat[..., 1:]
    c = cross(u, vec)
    return vec + 2.0 * (w * c + cross(u, c))


def quat_to_mat(q):
    """Quaternion -> 3x3 rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_quat(m):
    """3x3 rotation matrix -> unit quaternion (Shepperd's method): of the
    four constructions the one with the largest pivot, the sign made
    canonical (w >= 0)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    pivots = torch.sqrt(torch.clamp(pivots, min=1e-30)) / 2.0
    w0, x1, y2, z3 = (pivots[..., i] for i in range(4))
    cands = torch.stack([
        torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                     (m10 - m01) / (4 * w0)], -1),
        torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1),
                     (m02 + m20) / (4 * x1)], -1),
        torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2,
                     (m12 + m21) / (4 * y2)], -1),
        torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3),
                     (m12 + m21) / (4 * z3), z3], -1)], -2)
    pick = torch.argmax(pivots, dim=-1)[..., None, None].expand(
        pivots.shape[:-1] + (1, 4))
    q = torch.gather(cands, -2, pick).squeeze(-2)
    q = torch.where(q[..., :1] < 0, -q, q)
    return normalize(q)


def axis_angle_to_quat(axis, angle):
    half = angle * 0.5
    return torch.cat([torch.cos(half).unsqueeze(-1),
                      axis * torch.sin(half).unsqueeze(-1)], dim=-1)


def quat_integrate(q, omega, dt):
    """q (x) exp(omega dt / 2), renormalized (mju_quatIntegrate)."""
    angle = norm(omega) * dt
    dq = axis_angle_to_quat(normalize(omega), angle)
    return normalize(quat_mul(q, dq))


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_to_axis_angle(q):
    """The rotation vector (axis times angle, the angle wrapped into
    [-pi, pi]) of a unit quaternion (mju_quat2Vel with dt = 1)."""
    sin_half = norm(q[..., 1:])
    axis = q[..., 1:] / torch.clamp(sin_half, min=1e-15).unsqueeze(-1)
    angle = 2.0 * torch.atan2(sin_half, q[..., 0])
    angle = torch.where(angle > torch.pi, angle - 2 * torch.pi, angle)
    return axis * angle.unsqueeze(-1)


def quat_sub(qa, qb):
    """The angular velocity, in qb's frame, that turns qb into qa in unit
    time (mju_subQuat)."""
    return quat_to_axis_angle(quat_mul(quat_conj(qb), qa))


def motion_cross(v, m):
    """Spatial motion cross product v x m (mju_crossMotion)."""
    vang, vlin = v[..., :3], v[..., 3:]
    mang, mlin = m[..., :3], m[..., 3:]
    return torch.cat([cross(vang, mang),
                      cross(vang, mlin) + cross(vlin, mang)], dim=-1)


def force_cross(v, f):
    """Spatial force cross product v x* f (mju_crossForce)."""
    vang, vlin = v[..., :3], v[..., 3:]
    fang, flin = f[..., :3], f[..., 3:]
    return torch.cat([cross(vang, fang) + cross(vlin, flin),
                      cross(vang, flin)], dim=-1)


def transform_motion(vec, offset):
    """Moves a motion vector's reference point by ``offset``
    (mju_transformSpatial, flg_force=0, no rotation)."""
    ang, lin = vec[..., :3], vec[..., 3:]
    return torch.cat([ang, lin - cross(offset, ang)], dim=-1)


def transform_force(vec, offset):
    """Moves a force vector's reference point by ``offset``."""
    ang, lin = vec[..., :3], vec[..., 3:]
    return torch.cat([ang - cross(offset, lin), lin], dim=-1)


def mat_t_vec(mat, vec):
    """mat^T @ vec over the last two/one dimensions."""
    return torch.einsum("...ij,...i->...j", mat, vec)


def mat_vec(mat, vec):
    return torch.einsum("...ij,...j->...i", mat, vec)


def inert_from_body(mass, inertia_diag, ipos, imat):
    """10-vector spatial inertia of a body about a frame origin, with the
    CoM at ``ipos`` from it and principal axes ``imat`` (world axes)."""
    i_world = torch.einsum("...ij,...j,...kj->...ik", imat, inertia_diag,
                           imat)
    c = ipos
    c2 = dot(c, c)
    outer = c.unsqueeze(-1) * c.unsqueeze(-2)
    eye = torch.eye(3, dtype=i_world.dtype, device=i_world.device)
    shift = mass[..., None, None] * (c2[..., None, None] * eye - outer)
    i_total = i_world + shift
    ivec = torch.stack([
        i_total[..., 0, 0], i_total[..., 1, 1], i_total[..., 2, 2],
        i_total[..., 0, 1], i_total[..., 0, 2], i_total[..., 1, 2]], dim=-1)
    mass = mass.expand(c.shape[:-1])
    return torch.cat([ivec, mass.unsqueeze(-1) * c, mass.unsqueeze(-1)],
                     dim=-1)


def inert_mul(inert, vec):
    """Spatial inertia (10-vector) times a motion vector -> force vector:
    ang = I w + h x v, lin = m v - h x w with h = m c."""
    ixx, iyy, izz = inert[..., 0], inert[..., 1], inert[..., 2]
    ixy, ixz, iyz = inert[..., 3], inert[..., 4], inert[..., 5]
    h = inert[..., 6:9]
    m = inert[..., 9:10]
    w, v = vec[..., :3], vec[..., 3:]
    iw = torch.stack([
        ixx * w[..., 0] + ixy * w[..., 1] + ixz * w[..., 2],
        ixy * w[..., 0] + iyy * w[..., 1] + iyz * w[..., 2],
        ixz * w[..., 0] + iyz * w[..., 1] + izz * w[..., 2],
    ], dim=-1)
    return torch.cat([iw + cross(h, v), m * v - cross(h, w)], dim=-1)

