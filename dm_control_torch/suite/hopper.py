"""Hopper domain, batched (reference: dm_control/suite/hopper.py)."""

from __future__ import annotations

import collections

import torch

from dm_control_torch.suite import base
from dm_control_torch.suite.utils import randomizers
from dm_control_torch.utils import containers, rewards

_STAND_HEIGHT = 0.6
_HOP_SPEED = 2

TIME_LIMIT = 20
CONTROL_TIMESTEP = 0.02


class Hopper(base.Task):
    """Stand or hop forward."""

    observation_stages = "acc"  # the observation reads the touch sensors

    def __init__(self, hopping):
        self._hopping = hopping

    def init(self, m, qpos, qvel, rc, diff):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            m, qpos, rc)
        return qpos, qvel, diff

    def _height(self, m, d):
        return (self.xipos(m, d, "torso", "z")
                - self.xipos(m, d, "foot", "z"))

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["position"] = d.qpos[:, 1:]
        obs["velocity"] = d.qvel
        obs["touch"] = torch.log1p(torch.cat(
            [self.sensordata(m, d, "touch_toe"),
             self.sensordata(m, d, "touch_heel")], -1))
        return obs

    def reward(self, m, d):
        standing = rewards.tolerance(self._height(m, d), (_STAND_HEIGHT, 2))
        if self._hopping:
            speed = self.sensordata(m, d, "torso_subtreelinvel")[:, 0]
            hopping = rewards.tolerance(
                speed, bounds=(_HOP_SPEED, float("inf")),
                margin=_HOP_SPEED / 2, value_at_margin=0.5,
                sigmoid="linear")
            return standing * hopping
        small_control = torch.mean(rewards.tolerance(
            d.ctrl, margin=1, value_at_margin=0, sigmoid="quadratic"), -1)
        return standing * (small_control + 4) / 5


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def stand():
    return "hopper", Hopper(hopping=False)


@TASKS.add("benchmarking")
def hop():
    return "hopper", Hopper(hopping=True)
