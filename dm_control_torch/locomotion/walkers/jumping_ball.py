"""Ball-with-head walkers (counterpart of
``dm_control_tpu/locomotion/walkers/jumping_ball.py``; reference:
dm_control/locomotion/walkers/jumping_ball.py:28,147)."""

from __future__ import annotations

from dm_control_torch.locomotion.walkers import base
from dm_control_torch.mjcf.element import Element


class RollingBallWithHead(base.Walker):
    """A ball that rolls by torque on its two roll joints
    (reference jumping_ball.py:147)."""

    def _build(self, name="ball_walker", size=0.15, mass=2.0):
        root = Element("mujoco", {"model": name})
        wb = root.add("worldbody")
        body = wb.add("body", name="root")
        body.add("geom", name="shell", type="sphere", size=str(size),
                 mass=str(mass), condim="6", friction="0.7 0.005 0.02")
        head = body.add("body", name="head", pos=f"0 0 {size}")
        head.add("geom", name="head_geom", type="sphere",
                 size=str(size / 3), mass="0.1")
        # armature regularizes the roll DoFs, which parallel the free
        # joint's rotations (the reference's steering-wheel design)
        body.add("joint", name="roll_x", type="hinge", axis="1 0 0",
                 armature="0.02", damping="0.1")
        body.add("joint", name="roll_y", type="hinge", axis="0 1 0",
                 armature="0.02", damping="0.1")
        act = root.add("actuator")
        act.add("motor", name="roll_x", joint="roll_x", gear="5",
                ctrllimited="true", ctrlrange="-1 1")
        act.add("motor", name="roll_y", joint="roll_y", gear="5",
                ctrllimited="true", ctrlrange="-1 1")
        self._mjcf_root = root

    @property
    def root_body_name(self):
        return "root"

    @property
    def observable_joint_names(self):
        return ("roll_x", "roll_y")


class JumpingBallWithHead(RollingBallWithHead):
    """Adds a vertical jumping actuator (reference jumping_ball.py:28)."""

    def _build(self, name="jumping_ball", **kwargs):
        super()._build(name=name, **kwargs)
        wb = self._mjcf_root.first("worldbody")
        body = next(b for b in wb.children if b.tag == "body")
        body.add("joint", name="kick", type="slide", axis="0 0 1",
                 range="0 0.4", limited="true", stiffness="200",
                 damping="10")
        self._mjcf_root.first("actuator").add(
            "motor", name="kick", joint="kick", gear="40",
            ctrllimited="true", ctrlrange="0 1")

    @property
    def observable_joint_names(self):
        return ("roll_x", "roll_y", "kick")
