"""Kinova Jaco arm and hand entities (counterpart of
``dm_control_tpu/entities/manipulators/kinova.py``).

Reference: dm_control/entities/manipulators/kinova/jaco_arm.py:50-160 and
jaco_hand.py:36-156 — the 6-DoF Jaco with datasheet torque/velocity
limits, velocity actuators and per-joint torque sensors added
programmatically, and the 3-finger hand with grip/pinch sites.

The model literals (kinova_models.py, a copy of the JAX package's)
transcribe the reference MJCF with mesh mass models baked into explicit
inertials and mesh contacts served by oracle-AABB box proxies (see the
JAX package's _jacogen.py) — compiled body masses and inertias match the
oracle to 1e-8.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch import composer
from dm_control_torch.composer.observation.observable import Generic
from dm_control_torch.entities.manipulators.arm import RobotArm
from dm_control_torch.entities.manipulators.kinova_models import (
    ARM_MODEL, HAND_MODEL,
)
from dm_control_torch.suite._modelgen import to_element

_LARGE_JOINTS = ("joint_1", "joint_2", "joint_3")
_SMALL_JOINTS = ("joint_4", "joint_5", "joint_6")
ALL_JOINTS = _LARGE_JOINTS + _SMALL_JOINTS

# Kinova KA-75+/KA-58 datasheet limits (reference jaco_arm.py:36-47)
_LARGE_JOINT_MAX_TORQUE = 30.5
_SMALL_JOINT_MAX_TORQUE = 6.8
_LARGE_JOINT_MAX_VELOCITY = float(np.deg2rad(36.0))
_SMALL_JOINT_MAX_VELOCITY = float(np.deg2rad(48.0))
_VELOCITY_GAIN = 500.0

_FINGER_JOINTS = ("finger_1", "finger_2", "finger_3")


class JacoArm(RobotArm):
    """The 6-DoF Kinova Jaco (reference jaco_arm.py:50)."""

    def _build(self, name="jaco_arm"):
        root = to_element(ARM_MODEL)
        root.attrib["model"] = name
        act = root.first("actuator") or root.add("actuator")
        sensors = root.first("sensor") or root.add("sensor")
        self._joint_names = list(ALL_JOINTS)

        bodies = {e.get("name"): e for e in root.iter() if e.tag == "body"}
        joints = {e.get("name"): e for e in root.iter()
                  if e.tag == "joint"}
        for jname in ALL_JOINTS:
            large = jname in _LARGE_JOINTS
            max_t = _LARGE_JOINT_MAX_TORQUE if large \
                else _SMALL_JOINT_MAX_TORQUE
            max_v = _LARGE_JOINT_MAX_VELOCITY if large \
                else _SMALL_JOINT_MAX_VELOCITY
            act.add("velocity", name=jname, joint=jname,
                    kv=str(_VELOCITY_GAIN), ctrllimited="true",
                    ctrlrange=f"{-max_v} {max_v}", forcelimited="true",
                    forcerange=f"{-max_t} {max_t}")
            # torque sensor on a site in the joint's body
            # (reference jaco_arm.py:125-130)
            body = joints[jname].parent
            body.add("site", name=f"{jname}_site", size="0.001",
                     group="4")  # sensor-sites group
            sensors.add("torque", name=f"{jname}_torque",
                        site=f"{jname}_site")
        # the hand attaches at the last wrist body
        self._wrist_body = bodies["b_6"]
        if root.find("site", "wristsite") is None:
            self._wrist_body.add("site", name="wristsite", size="0.002")
        self._mjcf_root = root

    @property
    def wrist_site_name(self):
        return "wristsite"

    @property
    def wrist_body(self):
        return self._wrist_body

    def attach_hand(self, hand):
        return self.attach(hand, attach_site=self._wrist_body)

    def _build_observables(self):
        obs = composer.Observables(self)

        def joints_pos(physics):
            return np.asarray([physics.named_field(
                "qpos", f"{self.name}/{j}") for j in self._joint_names])

        def joints_vel(physics):
            return np.asarray([physics.named_field(
                "qvel", f"{self.name}/{j}") for j in self._joint_names])

        def joints_torque(physics):
            out = [physics.named_field(
                "sensordata", f"{self.name}/{j}_torque")
                for j in self._joint_names]
            return np.hstack(out)

        obs.add_observable("joints_pos", Generic(joints_pos))
        obs.add_observable("joints_vel", Generic(joints_vel))
        obs.add_observable("joints_torque", Generic(joints_torque))
        return obs


class JacoHand(composer.Entity):
    """The 3-finger Jaco hand (reference jaco_hand.py:36)."""

    def _build(self, name="jaco_hand"):
        root = to_element(HAND_MODEL)
        root.attrib["model"] = name
        act = root.first("actuator") or root.add("actuator")
        # grip-force tuned velocity actuators (reference jaco_hand.py:140)
        for jname in _FINGER_JOINTS:
            act.add("velocity", name=jname, joint=jname, kv="10",
                    ctrllimited="true", ctrlrange="-5 5",
                    forcelimited="true", forcerange="-1 1")
        self._joint_names = list(_FINGER_JOINTS)
        self._mjcf_root = root

    @property
    def joints(self):
        return self._joint_names

    @property
    def pinch_site_name(self):
        return "pinchsite"

    @property
    def grip_site_name(self):
        return "gripsite"
