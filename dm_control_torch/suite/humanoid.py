"""Humanoid domain, batched (reference: dm_control/suite/humanoid.py)."""

from __future__ import annotations

import collections

import torch

from dm_control_torch.physics import engine
from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.humanoid import MODEL
from dm_control_torch.suite.utils import randomizers
from dm_control_torch.utils import containers, rewards

_DEFAULT_TIME_LIMIT = 25
_CONTROL_TIMESTEP = 0.025
_STAND_HEIGHT = 1.4
_WALK_SPEED = 1
_RUN_SPEED = 10

TIME_LIMIT = _DEFAULT_TIME_LIMIT
CONTROL_TIMESTEP = _CONTROL_TIMESTEP


class Humanoid(base.Task):
    """Stand/walk/run; the initial pose is redrawn until it has no
    penetration."""

    max_reset_rejections = 100

    def __init__(self, move_speed, pure_state):
        self._move_speed = move_speed
        self._pure_state = pure_state

    def init(self, m, qpos, qvel, rc, diff):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            m, qpos, rc)
        return qpos, qvel, diff

    def reject(self, m, d):
        d = engine.fwd_position(m, d)
        return (d.contact.dist < 0).any(-1)

    def _com_velocity(self, m, d):
        return self.sensordata(m, d, "torso_subtreelinvel")

    def _head_height(self, m, d):
        return self.xpos(m, d, "head", "z")

    def observation(self, m, d):
        obs = collections.OrderedDict()
        if self._pure_state:
            obs["position"] = d.qpos
            obs["velocity"] = d.qvel
            return obs
        torso = m.names.body["torso"]
        obs["joint_angles"] = d.qpos[:, 7:]
        obs["head_height"] = self._head_height(m, d)
        torso_frame = d.xmat[:, torso]
        torso_pos = d.xpos[:, torso]
        positions = []
        for side in ("left_", "right_"):
            for limb in ("hand", "foot"):
                torso_to_limb = d.xpos[:, m.names.body[side + limb]] \
                    - torso_pos
                positions.append(torch.einsum("bi,bij->bj", torso_to_limb,
                                              torso_frame))
        obs["extremities"] = torch.cat(positions, dim=-1)
        # xmat['torso', ['zx', 'zy', 'zz']]: third row of the rotation
        obs["torso_vertical"] = d.xmat[:, torso, 2, :]
        obs["com_velocity"] = self._com_velocity(m, d)
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        standing = rewards.tolerance(
            self._head_height(m, d),
            bounds=(_STAND_HEIGHT, float("inf")), margin=_STAND_HEIGHT / 4)
        upright = rewards.tolerance(
            self.xmat(m, d, "torso", "zz"),
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
    dm_control/suite/humanoid.xml)."""
    return compile_domain_model(MODEL, device=device, dtype=dtype)


_MODEL = base.Variant("humanoid", get_model)


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def stand():
    return _MODEL, Humanoid(0, False)


@TASKS.add("benchmarking")
def walk():
    return _MODEL, Humanoid(_WALK_SPEED, False)


@TASKS.add("benchmarking")
def run():
    return _MODEL, Humanoid(_RUN_SPEED, False)


@TASKS.add()
def run_pure_state():
    return _MODEL, Humanoid(_RUN_SPEED, True)
