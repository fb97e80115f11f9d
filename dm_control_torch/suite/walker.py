"""Planar walker domain, batched (reference: dm_control/suite/walker.py)."""

from __future__ import annotations

import collections

import torch

from dm_control_torch.suite import base
from dm_control_torch.suite.utils import randomizers
from dm_control_torch.utils import containers, rewards

_STAND_HEIGHT = 1.2
_WALK_SPEED = 1
_RUN_SPEED = 8

TIME_LIMIT = 25
CONTROL_TIMESTEP = 0.025


class PlanarWalker(base.Task):
    """Stand, walk or run."""

    def __init__(self, move_speed):
        self._move_speed = move_speed

    def init(self, m, qpos, qvel, rc, diff):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            m, qpos, rc)
        return qpos, qvel, diff

    def observation(self, m, d):
        obs = collections.OrderedDict()
        # [xx, xz] of every body but the world, body-major
        obs["orientations"] = torch.stack(
            [d.xmat[:, 1:, 0, 0], d.xmat[:, 1:, 0, 2]], -1).flatten(1)
        obs["height"] = self.xpos(m, d, "torso", "z")
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        standing = rewards.tolerance(
            self.xpos(m, d, "torso", "z"),
            bounds=(_STAND_HEIGHT, float("inf")), margin=_STAND_HEIGHT / 2)
        upright = (1 + self.xmat(m, d, "torso", "zz")) / 2
        stand_reward = (3 * standing + upright) / 4
        if self._move_speed == 0:
            return stand_reward
        speed = self.sensordata(m, d, "torso_subtreelinvel")[:, 0]
        move_reward = rewards.tolerance(
            speed, bounds=(self._move_speed, float("inf")),
            margin=self._move_speed / 2, value_at_margin=0.5,
            sigmoid="linear")
        return stand_reward * (5 * move_reward + 1) / 6


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def stand():
    return "walker", PlanarWalker(0)


@TASKS.add("benchmarking")
def walk():
    return "walker", PlanarWalker(_WALK_SPEED)


@TASKS.add("benchmarking")
def run():
    return "walker", PlanarWalker(_RUN_SPEED)
