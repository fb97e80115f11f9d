"""Humanoid_CMU domain, batched: the 56-dof CMU skeleton (reference:
dm_control/suite/humanoid_CMU.py)."""

from __future__ import annotations

import collections

import torch

from dm_control_torch.physics import engine
from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.humanoid_CMU import MODEL
from dm_control_torch.suite.utils import randomizers
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 20
CONTROL_TIMESTEP = 0.02
_STAND_HEIGHT = 1.4
_WALK_SPEED = 1
_RUN_SPEED = 10


class HumanoidCMU(base.Task):
    """Stand/walk/run with the CMU skeleton; the initial pose is redrawn
    until it has no penetration."""

    max_reset_rejections = 100

    def __init__(self, move_speed):
        self._move_speed = move_speed

    def init(self, m, qpos, qvel, rc, diff):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            m, qpos, rc)
        return qpos, qvel, diff

    def reject(self, m, d):
        d = engine.fwd_position(m, d)
        return (d.contact.dist < 0).any(-1)

    def _com_velocity(self, m, d):
        return self.sensordata(m, d, "thorax_subtreelinvel")

    def observation(self, m, d):
        obs = collections.OrderedDict()
        thorax = m.names.body["thorax"]
        obs["joint_angles"] = d.qpos[:, 7:]
        obs["head_height"] = self.xpos(m, d, "head", "z")
        torso_frame = d.xmat[:, thorax]
        torso_pos = d.xpos[:, thorax]
        positions = []
        for side in ("l", "r"):
            for limb in ("hand", "foot"):
                torso_to_limb = d.xpos[:, m.names.body[side + limb]] \
                    - torso_pos
                positions.append(torch.einsum("bi,bij->bj", torso_to_limb,
                                              torso_frame))
        obs["extremities"] = torch.cat(positions, dim=-1)
        obs["torso_vertical"] = d.xmat[:, thorax, 2, :]
        obs["com_velocity"] = self._com_velocity(m, d)
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        standing = rewards.tolerance(
            self.xpos(m, d, "head", "z"),
            bounds=(_STAND_HEIGHT, float("inf")), margin=_STAND_HEIGHT / 4)
        upright = rewards.tolerance(
            self.xmat(m, d, "thorax", "zy"),
            bounds=(0.9, float("inf")), sigmoid="linear",
            margin=1.9, value_at_margin=0)
        stand_reward = standing * upright
        small_control = torch.mean(rewards.tolerance(
            d.ctrl, margin=1, value_at_margin=0, sigmoid="quadratic"), -1)
        small_control = (4 + small_control) / 5
        com_v = self._com_velocity(m, d)[:, :2]
        if self._move_speed == 0:
            dont_move = torch.mean(rewards.tolerance(com_v, margin=2), -1)
            return small_control * stand_reward * dont_move
        move = rewards.tolerance(
            torch.linalg.vector_norm(com_v, dim=-1),
            bounds=(self._move_speed, float("inf")),
            margin=self._move_speed, value_at_margin=0, sigmoid="linear")
        move = (5 * move + 1) / 6
        return small_control * stand_reward * move


def get_model(device=None, dtype: torch.dtype = torch.float64):
    """The domain's model, compiled from its literal tree (reference:
    dm_control/suite/humanoid_CMU.xml)."""
    return compile_domain_model(MODEL, device=device, dtype=dtype)


_MODEL = base.Variant("humanoid_CMU", get_model)


TASKS = containers.TaggedTasks()


@TASKS.add()
def stand():
    return _MODEL, HumanoidCMU(0)


@TASKS.add()
def walk():
    return _MODEL, HumanoidCMU(_WALK_SPEED)


@TASKS.add()
def run():
    return _MODEL, HumanoidCMU(_RUN_SPEED)
