"""Swimmer domain, batched (reference: dm_control/suite/swimmer.py).

A planar chain of links propelled by the drag of the medium; contacts are
disabled.  The 6- and the 15-link chain are two assets.  Each episode
places the target anew: the task overrides ``geom_pos`` per environment,
(B, ngeom, 3).
"""

from __future__ import annotations

import collections

import torch

from dm_control_torch.physics import mathx as mx
from dm_control_torch.suite import base
from dm_control_torch.suite.utils import randomizers
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 30
CONTROL_TIMESTEP = 0.03
#: columns of ``sensordata`` before the links' velocimeter and gyro pairs
_HEAD_SENSOR_VALUES = 12


class Swimmer(base.Task):
    """Swim the nose to the target."""

    def initial_model_diff(self, m):
        return {"geom_pos": m.geom_pos}

    def init(self, m, qpos, qvel, rc, diff):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            m, qpos, rc)
        # one episode in five has the target close by
        close = rc.rand() < 0.2
        tid = m.names.geom["target"]
        gp = diff["geom_pos"].expand(rc.batch, m.ngeom, 3).clone()
        if rc.is_numpy:  # the reference's draw, which rounds otherwise
            box = 0.3 if bool(close) else 2.0
            gp[:, tid, :2] = rc.uniform(-box, box, 2)
        else:
            box = torch.where(close, 0.3, 2.0).to(qpos.dtype)
            gp[:, tid, :2] = rc.uniform(-1.0, 1.0, 2) * box.unsqueeze(-1)
        return qpos, qvel, dict(diff, geom_pos=gp)

    def _nose_to_target(self, m, d):
        nose_to_target = (self.geom_xpos(m, d, "target")
                          - self.geom_xpos(m, d, "nose"))
        head = d.xmat[:, m.names.body["head"]]
        return mx.mat_t_vec(head, nose_to_target)[:, :2]

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["joints"] = d.qpos[:, 3:]
        obs["to_target"] = self._nose_to_target(m, d)
        # [vx, vy, wz] of each link from its velocimeter and gyro pair
        B = d.qpos.shape[0]
        xvel_local = d.sensordata[:, _HEAD_SENSOR_VALUES:].reshape(B, -1, 6)
        obs["body_velocities"] = xvel_local[:, :, [0, 1, 5]].reshape(B, -1)
        return obs

    def reward(self, m, d):
        target_size = m.cached("swimmer_target_size", lambda: float(
            m.geom_size[m.names.geom["target"], 0]))
        return rewards.tolerance(
            mx.norm(self._nose_to_target(m, d)), bounds=(0, target_size),
            margin=5 * target_size, sigmoid="long_tail")


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def swimmer6():
    return "swimmer6", Swimmer()


@TASKS.add("benchmarking")
def swimmer15():
    return "swimmer15", Swimmer()
