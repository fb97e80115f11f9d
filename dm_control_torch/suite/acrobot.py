"""Acrobot domain, batched (reference: dm_control/suite/acrobot.py)."""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.acrobot import MODEL
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 10
CONTROL_TIMESTEP = None


class Balance(base.Task):
    """Swing the tip up to the target."""

    def __init__(self, sparse):
        self._sparse = sparse

    def init(self, m, qpos, qvel, rc, diff):
        vals = rc.uniform(-math.pi, math.pi, 2)
        qpos = self.set_joint_qpos(m, qpos, "shoulder", vals[:, 0])
        qpos = self.set_joint_qpos(m, qpos, "elbow", vals[:, 1])
        return qpos, qvel, diff

    def observation(self, m, d):
        obs = collections.OrderedDict()
        arms = ("upper_arm", "lower_arm")
        obs["orientations"] = torch.stack(
            [self.xmat(m, d, arm, "xz") for arm in arms]
            + [self.xmat(m, d, arm, "zz") for arm in arms], -1)
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        target_radius = m.derived(
            "acrobot_target_radius", "site_size",
            lambda: float(m.site_size[m.names.site["target"], 0]))
        dist = torch.linalg.vector_norm(
            self.site_xpos(m, d, "target") - self.site_xpos(m, d, "tip"),
            dim=-1)
        return rewards.tolerance(dist, bounds=(0, target_radius),
                                 margin=0 if self._sparse else 1)


def get_model(device=None, dtype: torch.dtype = torch.float64):
    """The domain's model, compiled from its literal tree (reference:
    dm_control/suite/acrobot.xml)."""
    return compile_domain_model(MODEL, device=device, dtype=dtype)


_MODEL = base.Variant("acrobot", get_model)


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def swingup():
    return _MODEL, Balance(sparse=False)


@TASKS.add("benchmarking")
def swingup_sparse():
    return _MODEL, Balance(sparse=True)
