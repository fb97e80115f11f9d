"""State randomizers, batched (reference:
dm_control/suite/utils/randomizers.py:35)."""

from __future__ import annotations

import math

import numpy as np
import torch

from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import JointType, Model
from dm_control_torch.rl.control import RandomContext


def random_limited_quaternion(rc: RandomContext, limit):
    """Quaternions (B, 4) of a rotation by U[0, limit) radians about a
    direction drawn from N(0, I_3), normalized.  With a numpy source the
    draws and their arithmetic are the JAX package's numpy path's."""
    if rc.is_numpy:
        axis = rc.np_random.randn(3)
        axis = axis / np.linalg.norm(axis)
        angle = rc.np_random.rand() * limit
        return rc._host(np.concatenate([[np.cos(angle / 2)],
                                         axis * np.sin(angle / 2)]))
    axis = mx.normalize(rc.randn(3), eps=0.0)
    angle = rc.rand(1) * limit
    return torch.cat([torch.cos(angle / 2), axis * torch.sin(angle / 2)],
                     dim=-1)


def randomize_limited_and_rotational_joints(m: Model, qpos: torch.Tensor,
                                            rc: RandomContext):
    """qpos (B, nq) with joints drawn per the reference rules, in its
    order: a bounded hinge/slide uniform in its range, a bounded ball
    joint a rotation of at most its range's upper end
    (``random_limited_quaternion``), an unbounded hinge uniform in
    [-pi, pi), an unbounded ball joint a normalized draw from N(0, I_4), a
    free joint's orientation a normalized draw from U[0, 1)^4 (the
    reference's own rule for free joints, kept for comparable episode
    starts)."""
    qpos = qpos.clone()
    jr = m.cached("jnt_range_host", lambda: m.jnt_range.cpu().tolist())
    for j in range(m.njnt):
        jtype = JointType(m.jnt_type[j])
        adr = m.jnt_qposadr[j]
        lo, hi = jr[j]
        if m.jnt_limited[j] and jtype in (JointType.HINGE, JointType.SLIDE):
            qpos[:, adr] = rc.uniform(lo, hi)
        elif m.jnt_limited[j] and jtype == JointType.BALL:
            qpos[:, adr:adr + 4] = random_limited_quaternion(rc, hi)
        elif not m.jnt_limited[j] and jtype == JointType.HINGE:
            qpos[:, adr] = rc.uniform(-math.pi, math.pi)
        elif not m.jnt_limited[j] and jtype == JointType.BALL:
            qpos[:, adr:adr + 4] = _unit(rc, rc.randn(4))
        elif not m.jnt_limited[j] and jtype == JointType.FREE:
            qpos[:, adr + 3:adr + 7] = mx.normalize(rc.rand(4), eps=0.0)
    return qpos


def _unit(rc: RandomContext, quat):
    """A draw divided by its norm: numpy's ``np.linalg.norm`` for a numpy
    source (the JAX package's arithmetic), else on the device."""
    if rc.is_numpy:
        q = quat.cpu().numpy()[0]
        return rc._host(q / np.linalg.norm(q))
    return mx.normalize(quat, eps=0.0)
