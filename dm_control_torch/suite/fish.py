"""Fish domain, batched (reference: dm_control/suite/fish.py).

Swimming in three dimensions, driven by the drag of the medium (the
model's density and viscosity); gravity and all constraints are disabled.
``swim`` places the target anew each episode: the task overrides
``geom_pos`` per environment, (B, ngeom, 3).
"""

from __future__ import annotations

import collections

import torch

from dm_control_torch.physics import mathx as mx
from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.fish import MODEL
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 40
CONTROL_TIMESTEP = 0.04
_JOINTS = ["tail1", "tail_twist", "tail2", "finright_roll",
           "finright_pitch", "finleft_roll", "finleft_pitch"]


class _FishTask(base.Task):
    def _init_pose(self, m, qpos, rc):
        qpos = qpos.clone()
        root = m.jnt_qposadr[m.names.joint["root"]]
        qpos[:, root + 3:root + 7] = mx.normalize(rc.randn(4), eps=0.0)
        qadr = m.idx([m.jnt_qposadr[m.names.joint[j]] for j in _JOINTS])
        qpos[:, qadr] = rc.uniform(-0.2, 0.2, len(_JOINTS))
        return qpos

    def _joint_angles(self, m, d):
        return d.qpos[:, m.idx([m.jnt_qposadr[m.names.joint[j]]
                                for j in _JOINTS])]

    def _upright(self, m, d):
        return self.xmat(m, d, "torso", "zz")


class Upright(_FishTask):
    """Keep the torso upright."""

    def init(self, m, qpos, qvel, rc, diff):
        return self._init_pose(m, qpos, rc), qvel, diff

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["joint_angles"] = self._joint_angles(m, d)
        obs["upright"] = self._upright(m, d)
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        return rewards.tolerance(self._upright(m, d), bounds=(1, 1),
                                 margin=1)


class Swim(_FishTask):
    """Swim the mouth to the target, upright."""

    def initial_model_diff(self, m):
        return {"geom_pos": m.geom_pos}

    def init(self, m, qpos, qvel, rc, diff):
        qpos = self._init_pose(m, qpos, rc)
        tid = m.names.geom["target"]
        gp = diff["geom_pos"].expand(rc.batch, m.ngeom, 3).clone()
        gp[:, tid, 0] = rc.uniform(-0.4, 0.4)
        gp[:, tid, 1] = rc.uniform(-0.4, 0.4)
        gp[:, tid, 2] = rc.uniform(0.1, 0.3)
        return qpos, qvel, dict(diff, geom_pos=gp)

    def _mouth_to_target(self, m, d):
        mouth = m.names.geom["mouth"]
        return mx.mat_t_vec(d.geom_xmat[:, mouth],
                            self.geom_xpos(m, d, "target")
                            - d.geom_xpos[:, mouth])

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["joint_angles"] = self._joint_angles(m, d)
        obs["upright"] = self._upright(m, d)
        obs["target"] = self._mouth_to_target(m, d)
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        radii = m.cached("fish_radii", lambda: float(
            m.geom_size[m.names.geom["mouth"], 0]
            + m.geom_size[m.names.geom["target"], 0]))
        in_target = rewards.tolerance(
            mx.norm(self._mouth_to_target(m, d)), bounds=(0, radii),
            margin=2 * radii)
        is_upright = 0.5 * (self._upright(m, d) + 1)
        return (7 * in_target + is_upright) / 8


def get_model(device=None, dtype: torch.dtype = torch.float64):
    """The domain's model, compiled from its literal tree (reference:
    dm_control/suite/fish.xml)."""
    return compile_domain_model(MODEL, device=device, dtype=dtype)


_MODEL = base.Variant("fish", get_model)


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def upright():
    return _MODEL, Upright()


@TASKS.add("benchmarking")
def swim():
    return _MODEL, Swim()
