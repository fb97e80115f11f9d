"""The Kinova Jaco arm and hand, as names.

Counterpart of ``dm_control_tpu/entities/manipulators/kinova.py``: the
6-DoF arm's joints (each with a velocity actuator and a torque sensor on
``<joint>_site``), the hand's three finger joints and its grip and pinch
sites.  In a compiled task model every name is prefixed with the
attachment path (``arm/joint_1``, ``arm/hand/pinchsite``).
"""

from __future__ import annotations

_LARGE_JOINTS = ("joint_1", "joint_2", "joint_3")
_SMALL_JOINTS = ("joint_4", "joint_5", "joint_6")
ALL_JOINTS = _LARGE_JOINTS + _SMALL_JOINTS
_FINGER_JOINTS = ("finger_1", "finger_2", "finger_3")


class JacoArm:
    """The 6-DoF Kinova Jaco (reference jaco_arm.py:50)."""

    def __init__(self, name="jaco_arm"):
        self.name = name

    @property
    def joints(self):
        return ALL_JOINTS


class JacoHand:
    """The 3-finger Jaco hand (reference jaco_hand.py:36)."""

    def __init__(self, name="jaco_hand"):
        self.name = name

    @property
    def joints(self):
        return _FINGER_JOINTS

    @property
    def pinch_site_name(self):
        return "pinchsite"

    @property
    def grip_site_name(self):
        return "gripsite"
