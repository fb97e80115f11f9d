"""An arm's tool centre point put at a drawn pose by inverse kinematics
(counterpart of ``dm_control_tpu/composer/initializers/tcp_initializer.py``;
reference: dm_control/composer/initializers/tcp_initializer.py:30)."""

from __future__ import annotations

import numpy as np

from dm_control_torch.composer.variation.base import evaluate
from dm_control_torch.utils import inverse_kinematics as ik


class ToolCenterPointInitializer:
    """Draws a target pose for the hand's site and solves the arm's joints
    for it (``utils/inverse_kinematics.py``), again up to
    ``max_ik_attempts`` draws."""

    def __init__(self, hand_site_name, arm_joint_names, position,
                 quaternion=None, max_ik_attempts=10):
        self._site_name = hand_site_name
        self._joint_names = list(arm_joint_names)
        self._position = position
        self._quaternion = quaternion
        self._max_attempts = max_ik_attempts

    def __call__(self, physics, random_state):
        for _ in range(self._max_attempts):
            target_pos = np.asarray(evaluate(
                self._position, random_state=random_state))
            target_quat = (np.asarray(evaluate(
                self._quaternion, random_state=random_state))
                if self._quaternion is not None else None)
            result = ik.qpos_from_site_pose(
                physics.model, self._site_name, target_pos=target_pos,
                target_quat=target_quat, joint_names=self._joint_names,
                qpos0=physics.data.qpos.cpu().numpy())
            if result.success:
                physics.set_data(qpos=np.asarray(result.qpos))
                physics.forward()
                return
        raise RuntimeError(
            f"IK failed to place TCP after {self._max_attempts} attempts.")
