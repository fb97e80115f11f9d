"""Point-mass domain, batched (reference: dm_control/suite/point_mass.py).

Two fixed tendons couple the two actuators to the two slide joints.
``hard`` draws the coupling anew each episode: the task overrides
``wrap_prm`` per environment, (B, nwrap).
"""

from __future__ import annotations

import collections

import torch

from dm_control_torch.physics import mathx as mx
from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.point_mass import MODEL
from dm_control_torch.suite.utils import randomizers
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 20
CONTROL_TIMESTEP = None


class PointMass(base.Task):
    """Reach the target."""

    def __init__(self, randomize_gains):
        self._randomize_gains = randomize_gains

    def initial_model_diff(self, m):
        if self._randomize_gains:
            return {"wrap_prm": m.wrap_prm}
        return {}

    def init(self, m, qpos, qvel, rc, diff):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            m, qpos, rc)
        if self._randomize_gains:
            # two directions; a second one nearly parallel to the first is
            # drawn again (numpy: the reference's loop) or, batched,
            # replaced by the first turned a quarter (the JAX package's
            # traced rule)
            dir1 = mx.normalize(rc.randn(2), eps=0.0)
            dir2 = mx.normalize(rc.randn(2), eps=0.0)
            parallel = torch.abs(mx.dot(dir1, dir2)) > 0.9
            while rc.is_numpy and bool(parallel):
                dir2 = mx.normalize(rc.randn(2), eps=0.0)
                parallel = torch.abs(mx.dot(dir1, dir2)) > 0.9
            ortho = torch.stack([-dir1[:, 1], dir1[:, 0]], -1)
            dir2 = torch.where(parallel.unsqueeze(-1), ortho, dir2)
            wrap = diff["wrap_prm"].expand(rc.batch, m.nwrap).clone()
            wrap[:, 0:2] = dir1
            wrap[:, 2:4] = dir2
            diff = dict(diff, wrap_prm=wrap)
        return qpos, qvel, diff

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["position"] = d.qpos
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        target_size = m.cached("point_mass_target_size", lambda: float(
            m.geom_size[m.names.geom["target"], 0]))
        dist = torch.linalg.vector_norm(
            self.geom_xpos(m, d, "target") - self.geom_xpos(m, d,
                                                            "pointmass"),
            dim=-1)
        near_target = rewards.tolerance(dist, bounds=(0, target_size),
                                        margin=target_size)
        control_reward = torch.mean(rewards.tolerance(
            d.ctrl, margin=1, value_at_margin=0, sigmoid="quadratic"), -1)
        return near_target * (control_reward + 4) / 5


def get_model(device=None, dtype: torch.dtype = torch.float64):
    """The domain's model, compiled from its literal tree (reference:
    dm_control/suite/point_mass.xml)."""
    return compile_domain_model(MODEL, device=device, dtype=dtype)


_MODEL = base.Variant("point_mass", get_model)


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking", "easy")
def easy():
    return _MODEL, PointMass(randomize_gains=False)


@TASKS.add()
def hard():
    return _MODEL, PointMass(randomize_gains=True)
