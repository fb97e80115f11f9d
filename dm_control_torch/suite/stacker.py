"""Stacker domain, batched (reference: dm_control/suite/stacker.py).

The manipulator's arm stacks two or four boxes on a target; the two box
counts are two assets.  Every episode places the target at a drawn height
of an odd number of box sizes: the task overrides ``body_pos`` per
environment, (B, nbody, 3).
"""

from __future__ import annotations

import math

import torch

from dm_control_torch.physics import engine
from dm_control_torch.suite import base
from dm_control_torch.suite.manipulator import (
    arm_observations, body_2d_pose, init_arm,
)
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 10
CONTROL_TIMESTEP = 0.01
_CLOSE = 0.01


class Stack(base.Task):
    """Stack the boxes near the target."""

    observation_stages = "acc"  # reads the touch sensors
    max_reset_rejections = 100

    def __init__(self, n_boxes, fully_observable):
        self._n_boxes = n_boxes
        self._box_names = tuple(f"box{b}" for b in range(n_boxes))
        self._box_joint_names = tuple(f"{name}_{dim}"
                                      for name in self._box_names
                                      for dim in "xyz")
        self._fully_observable = fully_observable

    def initial_model_diff(self, m):
        return {"body_pos": m.body_pos}

    def reject(self, m, d):
        d = engine.fwd_position(m, d)
        return (d.contact.dist < 0).any(-1)

    def _box_size(self, m):
        return m.cached("stacker_box_size", lambda: float(
            m.geom_size[m.names.geom["target"], 0]))

    def init(self, m, qpos, qvel, rc, diff):
        qpos = init_arm(m, qpos, rc)
        target_height = (2 * rc.randint(0, self._n_boxes) + 1).to(
            qpos.dtype)
        tgt = m.names.body["target"]
        bp = diff["body_pos"].expand(rc.batch, m.nbody, 3).clone()
        bp[:, tgt, 2] = self._box_size(m) * target_height
        bp[:, tgt, 0] = rc.uniform(-0.37, 0.37)
        for name in self._box_names:
            qpos = self.set_joint_qpos(m, qpos, name + "_x",
                                       rc.uniform(0.1, 0.3))
            qpos = self.set_joint_qpos(m, qpos, name + "_z",
                                       rc.uniform(0, 0.7))
            qpos = self.set_joint_qpos(m, qpos, name + "_y",
                                       rc.uniform(0, 2 * math.pi))
        return qpos, qvel, dict(diff, body_pos=bp)

    def observation(self, m, d):
        obs = arm_observations(m, d)
        obs["touch"] = torch.log1p(d.sensordata)
        if self._fully_observable:
            obs["hand_pos"] = body_2d_pose(m, d, "hand")
            obs["box_pos"] = torch.stack(
                [body_2d_pose(m, d, n) for n in self._box_names], dim=1)
            obs["box_vel"] = d.qvel[:, m.idx(
                [m.jnt_dofadr[m.names.joint[j]]
                 for j in self._box_joint_names])]
            obs["target_pos"] = body_2d_pose(m, d, "target",
                                             orientation=False)
        return obs

    def reward(self, m, d):
        box_size = self._box_size(m)
        target = self.site_xpos(m, d, "target")
        dists = torch.stack([torch.linalg.vector_norm(
            self.site_xpos(m, d, n) - target, dim=-1)
            for n in self._box_names], dim=-1)
        box_is_close = rewards.tolerance(dists.min(-1).values,
                                         margin=2 * box_size)
        hand_to_target = torch.linalg.vector_norm(
            self.site_xpos(m, d, "grasp") - target, dim=-1)
        hand_is_far = rewards.tolerance(
            hand_to_target, bounds=(0.1, float("inf")), margin=_CLOSE)
        return box_is_close * hand_is_far


TASKS = containers.TaggedTasks()


@TASKS.add("hard")
def stack_2(fully_observable=True):
    return "stacker_2", Stack(2, fully_observable)


@TASKS.add("hard")
def stack_4(fully_observable=True):
    return "stacker_4", Stack(4, fully_observable)
