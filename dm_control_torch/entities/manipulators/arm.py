"""Robot arm + hand entities (counterpart of
``dm_control_tpu/entities/manipulators/arm.py``).

Reference: dm_control/entities/manipulators/base.py:193 (RobotArm with TCP
control) and kinova/jaco_arm.py:50-125 (velocity-actuated 6-DoF arm with
torque sensors) + jaco_hand.py (pinch site).

The reference's Kinova Jaco is mesh-based (third_party/kinova/
meshes_decimated); this primitive-geometry arm provides the equivalent
capability surface — velocity actuators, joint torque sensors, a
two-finger hand with a pinch site — with capsule links.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch import composer
from dm_control_torch.composer.observation.observable import Generic
from dm_control_torch.mjcf.element import Element


class RobotArm(composer.Entity):
    """Base arm interface (reference manipulators/base.py)."""

    @property
    def joints(self):
        return self._joint_names

    @property
    def wrist_site_name(self):
        return "wrist_site"

    def set_joint_angles(self, physics, angles):
        """Writes the joints' angles into qpos.  Like the JAX package's, it
        leaves the physics' dirty flag as it was: the episode's
        ``reset_context`` runs ``forward`` after it."""
        m = physics.model
        qpos = physics._data.qpos.clone()
        for name, angle in zip(self._joint_names, angles):
            j = m.names.joint[f"{self.name}/{name}"]
            qpos[0, m.jnt_qposadr[j]] = float(angle)
        physics._data = physics._data.replace(qpos=qpos)


class PrimitiveArm(RobotArm):
    """A 4-DoF arm with velocity actuators and torque sensors."""

    def _build(self, name="arm", link_lengths=(0.25, 0.25, 0.15)):
        root = Element("mujoco", {"model": name})
        root.add("option", timestep="0.002")
        wb = root.add("worldbody")
        act = root.add("actuator")
        sensors = root.add("sensor")
        self._joint_names = []

        base = wb.add("body", name="base", pos="0 0 0.05")
        base.add("geom", name="base_geom", type="box",
                 size="0.05 0.05 0.05", mass="2")
        parent = base
        axis_cycle = ["0 0 1", "0 1 0", "0 1 0", "1 0 0"]
        # base is welded to the world, so MuJoCo's parent-child contact
        # filter does NOT exclude base_geom vs link_geom_0 — the first
        # link must clear the base box (half-height 0.05 + radius 0.03).
        z = 0.09
        for i, length in enumerate(link_lengths):
            link = parent.add("body", name=f"link_{i}", pos=f"0 0 {z}")
            jname = f"joint_{i}"
            link.add("joint", name=jname, type="hinge",
                     axis=axis_cycle[i % 4], damping="2", armature="0.05",
                     limited="true", range="-170 170")
            link.add("geom", name=f"link_geom_{i}", type="capsule",
                     fromto=f"0 0 0 0 0 {length}", size="0.03", mass="1")
            site = link.add("site", name=f"torque_site_{i}", pos="0 0 0",
                            size="0.01")
            act.add("velocity", name=jname, joint=jname, kv="10",
                    ctrllimited="true", ctrlrange="-1 1")
            sensors.add("torque", name=f"torque_{i}",
                        site=f"torque_site_{i}")
            self._joint_names.append(jname)
            parent = link
            z = length
        # wrist
        wrist = parent.add("body", name="wrist", pos=f"0 0 {z}")
        wrist.add("joint", name="wrist_roll", type="hinge", axis="0 0 1",
                  damping="1", armature="0.02")
        wrist.add("geom", name="wrist_geom", type="sphere", size="0.035",
                  mass="0.3")
        wrist.add("site", name="wrist_site", pos="0 0 0.04", size="0.01")
        act.add("velocity", name="wrist_roll", joint="wrist_roll", kv="5",
                ctrllimited="true", ctrlrange="-1 1")
        self._joint_names.append("wrist_roll")
        self._wrist_body = wrist
        self._mjcf_root = root

    @property
    def wrist_body(self):
        """The wrist body element — hand attachment point
        (reference manipulators/base.py:219 attach_hand)."""
        return self._wrist_body

    def attach_hand(self, hand):
        """Attaches a hand entity at the wrist."""
        return self.attach(hand, attach_site=self._wrist_body)

    def _build_observables(self):
        obs = composer.Observables(self)

        def joints_pos(physics):
            return np.asarray([
                physics.named_field("qpos", f"{self.name}/{j}")
                for j in self._joint_names])

        def joints_vel(physics):
            return np.asarray([
                physics.named_field("qvel", f"{self.name}/{j}")
                for j in self._joint_names])

        def joints_torque(physics):
            out = []
            for i in range(len(self._joint_names) - 1):
                out.append(physics.named_field(
                    "sensordata", f"{self.name}/torque_{i}"))
            return np.hstack(out) if out else np.zeros(0)

        obs.add_observable("joints_pos", Generic(joints_pos))
        obs.add_observable("joints_vel", Generic(joints_vel))
        obs.add_observable("joints_torque", Generic(joints_torque))
        return obs


class PrimitiveHand(composer.Entity):
    """Two-finger gripper with a pinch site
    (reference kinova/jaco_hand.py)."""

    def _build(self, name="hand"):
        root = Element("mujoco", {"model": name})
        wb = root.add("worldbody")
        act = root.add("actuator")
        palm = wb.add("body", name="palm", pos="0 0 0.06")
        palm.add("geom", name="palm_geom", type="box",
                 size="0.03 0.015 0.01", mass="0.2")
        for i, side in enumerate((-1, 1)):
            finger = palm.add("body", name=f"finger_{i}",
                              pos=f"{side * 0.025} 0 0.02")
            finger.add("joint", name=f"finger_{i}", type="slide",
                       axis=f"{-side} 0 0", range="0 0.02",
                       limited="true", damping="5")
            finger.add("geom", name=f"finger_geom_{i}", type="box",
                       size="0.005 0.012 0.025", mass="0.05",
                       friction="1.5 0.05 0.001")
            act.add("position", name=f"finger_{i}", joint=f"finger_{i}",
                    kp="20", ctrllimited="true", ctrlrange="0 0.02")
        palm.add("site", name="pinch_site", pos="0 0 0.045", size="0.005")
        self._mjcf_root = root

    @property
    def pinch_site_name(self):
        return "pinch_site"
