"""State randomizers, batched (reference:
dm_control/suite/utils/randomizers.py:35)."""

from __future__ import annotations

import math

import torch

from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import JointType, Model
from dm_control_torch.rl.control import RandomContext


def randomize_limited_and_rotational_joints(m: Model, qpos: torch.Tensor,
                                            rc: RandomContext):
    """qpos (B, nq) with joints drawn per the reference rules: a bounded
    hinge/slide uniform in its range, an unbounded hinge uniform in
    [-pi, pi), a free joint's orientation a normalized draw from
    U[0, 1)^4 (the reference's own rule for free joints, kept for
    comparable episode starts)."""
    qpos = qpos.clone()
    jr = m.cached("jnt_range_host", lambda: m.jnt_range.cpu().tolist())
    for j in range(m.njnt):
        jtype = JointType(m.jnt_type[j])
        adr = m.jnt_qposadr[j]
        lo, hi = jr[j]
        if m.jnt_limited[j] and jtype in (JointType.HINGE, JointType.SLIDE):
            qpos[:, adr] = rc.uniform(lo, hi)
        elif not m.jnt_limited[j] and jtype == JointType.HINGE:
            qpos[:, adr] = rc.uniform(-math.pi, math.pi)
        elif not m.jnt_limited[j] and jtype == JointType.FREE:
            qpos[:, adr + 3:adr + 7] = mx.normalize(rc.rand(4), eps=0.0)
        elif jtype == JointType.BALL:
            raise NotImplementedError("ball joints are not ported yet "
                                      "(ROADMAP A5: composer, locomotion and "
                                      "manipulation)")
    return qpos
