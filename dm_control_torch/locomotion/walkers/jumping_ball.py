"""The rolling ball with a head, as names (counterpart of
``dm_control_tpu/locomotion/walkers/jumping_ball.py``): a sphere on a
free joint that rolls on two damped hinges, ``roll_x`` and ``roll_y``,
each driven by a motor, with a small sphere for a head."""

from __future__ import annotations

from dm_control_torch.locomotion.walkers import base


class RollingBallWithHead(base.Walker):
    """A ball that rolls by torque on its two roll joints."""

    def __init__(self, name="ball_walker", size=0.15, mass=2.0):
        super().__init__(name)
        self.size = size
        self.mass = mass

    @property
    def root_body_name(self):
        return "root"

    @property
    def observable_joint_names(self):
        return ("roll_x", "roll_y")
