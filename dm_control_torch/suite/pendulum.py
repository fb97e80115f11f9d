"""Pendulum domain, batched (reference: dm_control/suite/pendulum.py)."""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.pendulum import MODEL
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


def get_model(device=None, dtype: torch.dtype = torch.float64):
    """The domain's model, compiled from its literal tree (reference:
    dm_control/suite/pendulum.xml)."""
    return compile_domain_model(MODEL, device=device, dtype=dtype)


_MODEL = base.Variant("pendulum", get_model)


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def swingup():
    return _MODEL, SwingUp()
