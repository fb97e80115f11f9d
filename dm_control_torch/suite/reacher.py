"""Reacher domain, batched (reference: dm_control/suite/reacher.py).

Each episode places the target anew: the task overrides ``geom_pos`` per
environment, (B, ngeom, 3).  The two target sizes are two assets.
"""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.suite import base
from dm_control_torch.suite.utils import randomizers
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 20
CONTROL_TIMESTEP = None


class Reacher(base.Task):
    """Touch the target with the finger."""

    def initial_model_diff(self, m):
        return {"geom_pos": m.geom_pos}

    def init(self, m, qpos, qvel, rc, diff):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            m, qpos, rc)
        angle = rc.uniform(0, 2 * math.pi)
        radius = rc.uniform(0.05, 0.20)
        tid = m.names.geom["target"]
        gp = diff["geom_pos"].expand(rc.batch, m.ngeom, 3).clone()
        gp[:, tid, 0] = radius * torch.sin(angle)
        gp[:, tid, 1] = radius * torch.cos(angle)
        return qpos, qvel, dict(diff, geom_pos=gp)

    def _finger_to_target(self, m, d):
        return (self.geom_xpos(m, d, "target")[:, :2]
                - self.geom_xpos(m, d, "finger")[:, :2])

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["position"] = d.qpos
        obs["to_target"] = self._finger_to_target(m, d)
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        radii = m.cached("reacher_radii", lambda: float(
            m.geom_size[m.names.geom["target"], 0]
            + m.geom_size[m.names.geom["finger"], 0]))
        dist = torch.linalg.vector_norm(self._finger_to_target(m, d), dim=-1)
        return rewards.tolerance(dist, (0, radii))


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking", "easy")
def easy():
    return "reacher_easy", Reacher()


@TASKS.add("benchmarking")
def hard():
    return "reacher_hard", Reacher()
