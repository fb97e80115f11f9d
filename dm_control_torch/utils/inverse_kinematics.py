"""Inverse kinematics: damped-least-squares site-pose solver.

Counterpart of ``dm_control_tpu/utils/inverse_kinematics.py`` (reference:
dm_control/utils/inverse_kinematics.py:37-260, ``qpos_from_site_pose``
and ``nullspace_method``): forward kinematics and the site Jacobian come
from the port's batched ``kinematics`` at one environment, integration
from ``engine.integrate_pos``; the least-squares steps are numpy on the
host, as in the reference.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from dm_control_torch.physics import engine, kinematics as kin
from dm_control_torch.physics.index import JOINT_WIDTHS
from dm_control_torch.physics.model import Model, make_data

IKResult = collections.namedtuple(
    "IKResult", ["qpos", "err_norm", "steps", "success"])

_INVALID_JOINT_NAMES_TYPE = (
    "`joint_names` must be either None, a list, a tuple, or a numpy array; "
    "got {}.")
_REQUIRE_TARGET_POS_OR_QUAT = (
    "At least one of `target_pos` or `target_quat` must be specified.")


def nullspace_method(jac_joints, delta, regularization_strength=0.0):
    """Joint update achieving the end-effector ``delta``
    (reference inverse_kinematics.py:233)."""
    hess_approx = jac_joints.T.dot(jac_joints)
    joint_delta = jac_joints.T.dot(delta)
    if regularization_strength > 0:
        hess_approx += np.eye(hess_approx.shape[0]) * regularization_strength
        return np.linalg.solve(hess_approx, joint_delta)
    return np.linalg.lstsq(hess_approx, joint_delta, rcond=-1)[0]


def _quat_mul(u, v):
    w1, x1, y1, z1 = u
    w2, x2, y2, z2 = v
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _mat_to_quat(m):
    """Rotation matrix -> unit quaternion with w >= 0 (Shepperd's method,
    the candidate with the largest diagonal term)."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    diag = np.array([1.0 + tr, 1.0 + m[0, 0] - m[1, 1] - m[2, 2],
                     1.0 - m[0, 0] + m[1, 1] - m[2, 2],
                     1.0 - m[0, 0] - m[1, 1] + m[2, 2]])
    diag = np.sqrt(np.maximum(diag, 1e-30)) / 2.0
    a = diag
    cands = (
        [a[0], (m[2, 1] - m[1, 2]) / (4 * a[0]),
         (m[0, 2] - m[2, 0]) / (4 * a[0]), (m[1, 0] - m[0, 1]) / (4 * a[0])],
        [(m[2, 1] - m[1, 2]) / (4 * a[1]), a[1],
         (m[0, 1] + m[1, 0]) / (4 * a[1]), (m[0, 2] + m[2, 0]) / (4 * a[1])],
        [(m[0, 2] - m[2, 0]) / (4 * a[2]), (m[0, 1] + m[1, 0]) / (4 * a[2]),
         a[2], (m[1, 2] + m[2, 1]) / (4 * a[2])],
        [(m[1, 0] - m[0, 1]) / (4 * a[3]), (m[0, 2] + m[2, 0]) / (4 * a[3]),
         (m[1, 2] + m[2, 1]) / (4 * a[3]), a[3]])
    q = np.array(cands[int(np.argmax(diag))])
    if q[0] < 0:
        q = -q
    return q / max(np.sqrt(np.sum(q * q)), 1e-15)


def _quat_to_axis_angle(q):
    """Quaternion -> rotation vector (axis * angle, angle in [-pi, pi])."""
    sin_half = np.linalg.norm(q[1:])
    angle = 2.0 * np.arctan2(sin_half, q[0])
    if angle > np.pi:
        angle -= 2 * np.pi
    return q[1:] / max(sin_half, 1e-15) * angle


def qpos_from_site_pose(model: Model,
                        site_name: str,
                        target_pos=None,
                        target_quat=None,
                        joint_names=None,
                        qpos0=None,
                        tol=1e-14,
                        rot_weight=1.0,
                        regularization_threshold=0.1,
                        regularization_strength=3e-2,
                        max_update_norm=2.0,
                        progress_thresh=20.0,
                        max_steps=100):
    """Finds qpos placing a site at a target pose (the reference's
    ``qpos_from_site_pose``, on a Model and an initial qpos (numpy, nq)
    instead of a stateful Physics)."""
    if target_pos is None and target_quat is None:
        raise ValueError(_REQUIRE_TARGET_POS_OR_QUAT)
    m = model
    siteid = m.names.site[site_name]

    if joint_names is None:
        dof_indices = np.arange(m.nv)
    elif isinstance(joint_names, (list, np.ndarray, tuple)):
        dofs = []
        for name in joint_names:
            j = m.names.joint[name]
            adr = m.jnt_dofadr[j]
            dofs.extend(range(adr, adr + JOINT_WIDTHS[m.jnt_type[j]][1]))
        dof_indices = np.array(sorted(dofs))
    else:
        raise ValueError(_INVALID_JOINT_NAMES_TYPE.format(type(joint_names)))

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=m.dtype,
                               device=m.device).unsqueeze(0)

    qpos = np.array(m.qpos0.cpu().numpy() if qpos0 is None else qpos0,
                    dtype=np.float64)
    d0 = make_data(m, 1)
    steps = 0
    success = False
    err_norm = 0.0
    for steps in range(max_steps):
        d = kin.com_pos(m, kin.kinematics(m, d0.replace(qpos=tensor(qpos))))
        site_xpos = d.site_xpos[0, siteid].cpu().numpy()
        err_norm = 0.0
        err_parts = []
        if target_pos is not None:
            err_pos = np.asarray(target_pos) - site_xpos
            err_norm += np.linalg.norm(err_pos)
            err_parts.append(err_pos)
        if target_quat is not None:
            site_xquat = _mat_to_quat(d.site_xmat[0, siteid].cpu().numpy())
            err_rot_quat = _quat_mul(np.asarray(target_quat, float),
                                     site_xquat * np.array([1.0, -1, -1, -1]))
            err_rot = _quat_to_axis_angle(err_rot_quat)
            err_norm += np.linalg.norm(err_rot) * rot_weight
            err_parts.append(err_rot)
        if err_norm < tol:
            success = True
            break
        jacp, jacr = kin.jac_site(m, d, siteid)
        jac_full = []
        if target_pos is not None:
            jac_full.append(jacp[0].cpu().numpy())
        if target_quat is not None:
            jac_full.append(jacr[0].cpu().numpy())
        jac_joints = np.concatenate(jac_full, axis=0)[:, dof_indices]
        err = np.concatenate(err_parts)
        reg = (regularization_strength
               if err_norm > regularization_threshold else 0.0)
        update_joints = nullspace_method(jac_joints, err,
                                         regularization_strength=reg)
        update_norm = np.linalg.norm(update_joints)
        if update_norm == 0.0:
            break
        if err_norm / update_norm > progress_thresh:
            break
        if update_norm > max_update_norm:
            update_joints *= max_update_norm / update_norm
        update_nv = np.zeros(m.nv)
        update_nv[dof_indices] = update_joints
        qpos = engine.integrate_pos(m, tensor(qpos), tensor(update_nv),
                                    1.0)[0].cpu().numpy()
    return IKResult(qpos=qpos, err_norm=err_norm, steps=steps,
                    success=success)
