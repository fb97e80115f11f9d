"""Pendulum domain, batched (reference: dm_control/suite/pendulum.py)."""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.suite import base
from dm_control_torch.utils import containers, rewards

_ANGLE_BOUND = 8
_COSINE_BOUND = math.cos(math.radians(_ANGLE_BOUND))

TIME_LIMIT = 20
CONTROL_TIMESTEP = None


class SwingUp(base.Task):
    """Swing up and balance the pole."""

    def init(self, m, qpos, qvel, rc, diff):
        qpos = self.set_joint_qpos(m, qpos, "hinge",
                                   rc.uniform(-math.pi, math.pi))
        return qpos, qvel, diff

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["orientation"] = torch.stack([self.xmat(m, d, "pole", "zz"),
                                          self.xmat(m, d, "pole", "xz")], -1)
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        return rewards.tolerance(self.xmat(m, d, "pole", "zz"),
                                 (_COSINE_BOUND, 1))


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def swingup():
    return "pendulum", SwingUp()
