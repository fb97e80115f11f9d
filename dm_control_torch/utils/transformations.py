"""Rigid-body transformations: quaternion / euler / rotation-matrix algebra.

The port's own copy of ``dm_control_tpu/utils/transformations.py``, the
API of dm_control/utils/transformations.py:261-620 in numpy (host-side
utilities in the reference too); the batched torch equivalents on the
step's path live in ``dm_control_torch.physics.mathx``.

Quaternions are (w, x, y, z).  Euler orderings: uppercase = intrinsic
(rotating frame), lowercase = extrinsic (static frame).
"""

from __future__ import annotations

import numpy as np

_POLE_LIMIT = 1.0 - 1e-6
_TOL = 1e-5


def _clip_within_precision(number, low, high, precision=_TOL):
    if np.any(number < low - precision) or np.any(number > high + precision):
        raise ValueError(
            f"Input {number} is outside the range [{low}, {high}] beyond "
            f"precision {precision}.")
    return np.clip(number, low, high)


def _axis_rotation(theta, full):
    """Returns the theta dim, cos and sin, and blank matrix for axis rot."""
    n = 1 if np.isscalar(theta) else len(theta)
    ct, st = np.cos(theta), np.sin(theta)
    if full:
        rmat = np.zeros((n, 4, 4))
        rmat[:, 3, 3] = 1.0
    else:
        rmat = np.zeros((n, 3, 3))
    return n, ct, st, rmat


def rotation_x_axis(theta, full=False):
    n, ct, st, rmat = _axis_rotation(theta, full)
    rmat[:, 0, 0:3] = np.array([[1, 0, 0]])
    rmat[:, 1, 0:3] = np.vstack([np.zeros(n), ct, -st]).T
    rmat[:, 2, 0:3] = np.vstack([np.zeros(n), st, ct]).T
    return rmat.squeeze() if np.isscalar(theta) else rmat


def rotation_y_axis(theta, full=False):
    n, ct, st, rmat = _axis_rotation(theta, full)
    rmat[:, 0, 0:3] = np.vstack([ct, np.zeros(n), st]).T
    rmat[:, 1, 0:3] = np.array([[0, 1, 0]])
    rmat[:, 2, 0:3] = np.vstack([-st, np.zeros(n), ct]).T
    return rmat.squeeze() if np.isscalar(theta) else rmat


def rotation_z_axis(theta, full=False):
    n, ct, st, rmat = _axis_rotation(theta, full)
    rmat[:, 0, 0:3] = np.vstack([ct, -st, np.zeros(n)]).T
    rmat[:, 1, 0:3] = np.vstack([st, ct, np.zeros(n)]).T
    rmat[:, 2, 0:3] = np.array([[0, 0, 1]])
    return rmat.squeeze() if np.isscalar(theta) else rmat


def rotation_matrix_2d(theta):
    ct, st = np.cos(theta), np.sin(theta)
    return np.array([[ct, -st], [st, ct]])


# ---------------------------------------------------------------------------
# Quaternions.
# ---------------------------------------------------------------------------


def quat_conj(quat):
    quat = np.asarray(quat)
    return np.stack(
        [quat[..., 0], -quat[..., 1], -quat[..., 2], -quat[..., 3]],
        axis=-1).astype(np.float64)


def quat_inv(quat):
    quat = np.asarray(quat)
    return quat_conj(quat) / np.sum(quat * quat, axis=-1, keepdims=True)


def quat_mul(quat1, quat2):
    """Hamilton product, supporting batched inputs."""
    a = np.asarray(quat1, dtype=np.float64)
    b = np.asarray(quat2, dtype=np.float64)
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def quat_diff(source, target):
    """Passive rotation from source to target: conj(source) * target."""
    return quat_mul(quat_conj(source), target)


def quat_log(quat, tol=_TOL):
    """Log of a quaternion (batched); numerics match the reference
    (transformations.py:389-424) including its tol offsets."""
    quat = np.asarray(quat)
    q_norm = np.linalg.norm(quat + tol, axis=-1, keepdims=True)
    a = quat[..., 0:1]
    v = np.stack([quat[..., 1], quat[..., 2], quat[..., 3]], axis=-1)
    v_new = (v / np.linalg.norm(v + tol, axis=-1, keepdims=True)
             * np.arccos(_clip_within_precision(
                 a - tol, -1.0, 1.0, precision=2.0 * tol)) / q_norm)
    return np.stack(
        [np.log(q_norm[..., 0]), v_new[..., 0], v_new[..., 1],
         v_new[..., 2]], axis=-1)


def quat_dist(source, target):
    """Rotational distance between unit quaternions, in [0, pi]."""
    quat_product = quat_mul(source, quat_inv(target))
    quat_product /= np.linalg.norm(quat_product, axis=-1, keepdims=True)
    return np.linalg.norm(quat_log(quat_product), axis=-1)


def quat_rotate(quat, vec):
    """Rotates ``vec`` by ``quat``."""
    qvec = np.concatenate([[0.0], np.asarray(vec, dtype=np.float64)])
    return quat_mul(quat_mul(quat, qvec), quat_conj(quat))[1:]


def quat_to_axisangle(quat):
    """Unit quaternion → axis-angle 3-vector."""
    quat = np.asarray(quat, dtype=np.float64)
    angle = 2 * np.arccos(_clip_within_precision(quat[0], -1.0, 1.0))
    if angle < _TOL:
        return np.zeros(3)
    qn = np.sin(angle / 2)
    angle = (angle + np.pi) % (2 * np.pi) - np.pi
    return quat[1:4] / qn * angle


def quat_to_mat(quat):
    """Unit quaternion → 4x4 homogeneous rotation matrix."""
    q = np.asarray(quat, dtype=np.float64).copy()
    nq = q @ q
    if nq < _TOL:
        return np.identity(4)
    q *= np.sqrt(2.0 / nq)
    q = np.outer(q, q)
    return np.array(
        ((1.0 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0], 0.0),
         (q[1, 2] + q[3, 0], 1.0 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0], 0.0),
         (q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1.0 - q[1, 1] - q[2, 2], 0.0),
         (0.0, 0.0, 0.0, 1.0)))


def mat_to_quat(mat):
    """3x3 or 4x4 rotation matrix → quaternion [w, i, j, k].

    Sign/branch conventions match the reference implementation exactly
    (transformations.py:579-625)."""
    mat = np.asarray(mat, dtype=np.float64)
    if mat.shape == (3, 3):
        tmp = np.eye(4)
        tmp[0:3, 0:3] = mat
        mat = tmp
    q = np.empty((4,), dtype=np.float64)
    t = np.trace(mat)
    if t > mat[3, 3]:
        q[0] = t
        q[3] = mat[1, 0] - mat[0, 1]
        q[2] = mat[0, 2] - mat[2, 0]
        q[1] = mat[2, 1] - mat[1, 2]
    else:
        i, j, k = 0, 1, 2
        if mat[1, 1] > mat[0, 0]:
            i, j, k = 1, 2, 0
        if mat[2, 2] > mat[i, i]:
            i, j, k = 2, 0, 1
        t = mat[i, i] - (mat[j, j] + mat[k, k]) + mat[3, 3]
        q[i + 1] = t
        q[j + 1] = mat[i, j] + mat[j, i]
        q[k + 1] = mat[k, i] + mat[i, k]
        q[0] = mat[k, j] - mat[j, k]
    q *= 0.5 / np.sqrt(t * mat[3, 3])
    return q


# ---------------------------------------------------------------------------
# Euler angles.
# ---------------------------------------------------------------------------


def _rmat_to_euler_xyz(rmat):
    if rmat[0, 2] > _POLE_LIMIT:
        z = np.arctan2(rmat[1, 0], rmat[1, 1])
        y = np.pi / 2
        x = 0.0
    elif rmat[0, 2] < -_POLE_LIMIT:
        z = np.arctan2(rmat[1, 0], rmat[1, 1])
        y = -np.pi / 2
        x = 0.0
    else:
        z = -np.arctan2(rmat[0, 1], rmat[0, 0])
        y = np.arcsin(rmat[0, 2])
        x = -np.arctan2(rmat[1, 2], rmat[2, 2])
    return np.array([x, y, z])


def _rmat_to_euler_xyx(rmat):
    if rmat[0, 0] > _POLE_LIMIT:
        return np.array([np.arctan2(rmat[2, 1], rmat[2, 2]), 0.0, 0.0])
    if rmat[0, 0] < -_POLE_LIMIT:
        return np.array([np.arctan2(rmat[2, 1], rmat[2, 2]), np.pi, 0.0])
    x0 = np.arctan2(rmat[1, 0], -rmat[2, 0])
    y = np.arccos(_clip_within_precision(rmat[0, 0], -1.0, 1.0))
    x1 = np.arctan2(rmat[0, 1], rmat[0, 2])
    return np.array([x0, y, x1])


def _rmat_to_euler_zyx(rmat):
    if rmat[2, 0] > _POLE_LIMIT:
        x = np.arctan2(rmat[0, 1], rmat[0, 2])
        y = -np.pi / 2
        z = 0.0
    elif rmat[2, 0] < -_POLE_LIMIT:
        x = np.arctan2(rmat[0, 1], rmat[0, 2])
        y = np.pi / 2
        z = 0.0
    else:
        x = np.arctan2(rmat[2, 1], rmat[2, 2])
        y = -np.arcsin(rmat[2, 0])
        z = np.arctan2(rmat[1, 0], rmat[0, 0])
    return np.array([z, y, x])


def _rmat_to_euler_xzy(rmat):
    if rmat[0, 1] > _POLE_LIMIT:
        y = np.arctan2(rmat[1, 2], rmat[1, 0])
        z = -np.pi / 2
        x = 0.0
    elif rmat[0, 1] < -_POLE_LIMIT:
        y = np.arctan2(rmat[1, 2], rmat[1, 0])
        z = np.pi / 2
        x = 0.0
    else:
        y = np.arctan2(rmat[0, 2], rmat[0, 0])
        z = -np.arcsin(rmat[0, 1])
        x = np.arctan2(rmat[2, 1], rmat[1, 1])
    return np.array([x, z, y])


def _rmat_to_euler_yzx(rmat):
    if rmat[1, 0] > _POLE_LIMIT:
        x = -np.arctan2(rmat[0, 2], rmat[0, 1])
        z = np.pi / 2
        y = 0.0
    elif rmat[1, 0] < -_POLE_LIMIT:
        x = -np.arctan2(rmat[0, 2], rmat[0, 1])
        z = -np.pi / 2
        y = 0.0
    else:
        x = -np.arctan2(rmat[1, 2], rmat[1, 1])
        z = np.arcsin(rmat[1, 0])
        y = -np.arctan2(rmat[2, 0], rmat[0, 0])
    return np.array([y, z, x])


def _rmat_to_euler_zxy(rmat):
    if rmat[2, 1] > _POLE_LIMIT:
        y = np.arctan2(rmat[0, 2], rmat[0, 0])
        x = np.pi / 2
        z = 0.0
    elif rmat[2, 1] < -_POLE_LIMIT:
        y = np.arctan2(rmat[0, 2], rmat[0, 0])
        x = -np.pi / 2
        z = 0.0
    else:
        y = -np.arctan2(rmat[2, 0], rmat[2, 2])
        x = np.arcsin(rmat[2, 1])
        z = -np.arctan2(rmat[0, 1], rmat[1, 1])
    return np.array([z, x, y])


def _rmat_to_euler_yxz(rmat):
    if rmat[1, 2] > _POLE_LIMIT:
        z = -np.arctan2(rmat[0, 1], rmat[0, 0])
        x = -np.pi / 2
        y = 0.0
    elif rmat[1, 2] < -_POLE_LIMIT:
        z = -np.arctan2(rmat[0, 1], rmat[0, 0])
        x = np.pi / 2
        y = 0.0
    else:
        z = np.arctan2(rmat[1, 0], rmat[1, 1])
        x = -np.arcsin(rmat[1, 2])
        y = np.arctan2(rmat[0, 2], rmat[2, 2])
    return np.array([y, x, z])


_eulermap = {
    "XYZ": _rmat_to_euler_xyz,
    "XYX": _rmat_to_euler_xyx,
    "ZYX": _rmat_to_euler_zyx,
    "XZY": _rmat_to_euler_xzy,
    "YZX": _rmat_to_euler_yzx,
    "ZXY": _rmat_to_euler_zxy,
    "YXZ": _rmat_to_euler_yxz,
}

_axis_rotations = {"X": rotation_x_axis, "Y": rotation_y_axis,
                   "Z": rotation_z_axis}


def euler_to_rmat(euler_vec, ordering="ZXZ", full=False):
    """Euler angles → rotation matrix.

    ``ordering`` gives rotations in matrix-multiplication order: for XYZ
    the result is rotX(r1) @ rotY(r2) @ rotZ(r3) (reference
    transformations.py:275)."""
    rots = [_axis_rotations[c](np.atleast_2d(euler_vec)[:, i], full)
            for i, c in enumerate(ordering)]
    if rots[0].ndim == 3:
        return _batch_mm(_batch_mm(rots[0], rots[1]), rots[2]).squeeze()
    return (rots[0] @ rots[1]) @ rots[2]


def euler_to_quat(euler_vec, ordering="XYZ"):
    mat = euler_to_rmat(euler_vec, ordering=ordering)
    return mat_to_quat(mat)


def rmat_to_euler(rmat, ordering="ZXZ"):
    """Rotation matrix → euler angles for the supported orderings."""
    return _eulermap[ordering](np.asarray(rmat)[:3, :3])


def quat_to_euler(quat, ordering="XYZ"):
    return rmat_to_euler(quat_to_mat(quat)[0:3, 0:3], ordering=ordering)


def _batch_mm(m1, m2):
    return np.einsum("nij,njk->nik", m1, m2)


def pos_to_hmat(pos):
    """Position → homogeneous transform."""
    out = np.identity(4)
    out[:3, 3] = pos
    return out


def hmat_inv(hmat):
    """Inverse of a homogeneous transform."""
    rot = hmat[:3, :3]
    pos = hmat[:3, 3]
    out = np.identity(4)
    out[:3, :3] = rot.T
    out[:3, 3] = -rot.T @ pos
    return out
