"""Reacher domain, batched (reference: dm_control/suite/reacher.py).

Each episode places the target anew: the task overrides ``geom_pos`` per
environment, (B, ngeom, 3).  The target's size is set in the tree before
it is compiled, as the JAX package's ``get_model`` does.
"""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.reacher import MODEL
from dm_control_torch.suite.utils import randomizers
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 20
CONTROL_TIMESTEP = None
_BIG_TARGET = 0.05
_SMALL_TARGET = 0.015


def get_model(target_size, device=None, dtype: torch.dtype = torch.float64):
    """The model with a target of radius ``target_size``."""
    def mutate(root):
        wb = root.first("worldbody")
        target = next(g for g in wb.children
                      if g.tag == "geom" and g.get("name") == "target")
        target.attrib["size"] = str(target_size)

    return compile_domain_model(MODEL, mutate=mutate, cache_key=target_size,
                                device=device, dtype=dtype)


def _model(name, target_size):
    return base.Variant(name, lambda device, dtype: get_model(
        target_size, device, dtype))


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
    return _model("reacher_easy", _BIG_TARGET), Reacher()


@TASKS.add("benchmarking")
def hard():
    return _model("reacher_hard", _SMALL_TARGET), Reacher()
