"""Target sphere prop
(reference: dm_control/locomotion/props/target_sphere.py).

Counterpart of ``dm_control_tpu/locomotion/props/target_sphere.py``.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch import composer
from dm_control_torch.mjcf.element import Element


class TargetSphere(composer.Entity):
    """A non-colliding sphere that detects entity proximity."""

    def _build(self, radius=0.6, height_above_ground=1, name="target"):
        self._radius = radius
        root = Element("mujoco", {"model": name})
        wb = root.add("worldbody")
        body = wb.add("body", name="body",
                      pos=f"0 0 {height_above_ground}")
        body.add("geom", name="geom", type="sphere", size=str(radius),
                 contype="0", conaffinity="0", mass="0.001")
        self._mjcf_root = root
        self._activated = False

    @property
    def radius(self):
        return self._radius

    @property
    def activated(self):
        return self._activated

    def reset(self, physics):
        self._activated = False

    def initialize_episode(self, physics, random_state):
        self._activated = False

    def distance(self, physics, other_xpos):
        center = np.asarray(physics.named_field(
            "xpos", self.attachment_frame.get("name")))
        return float(np.linalg.norm(np.asarray(other_xpos) - center))

    def maybe_activate(self, physics, other_xpos):
        if self.distance(physics, other_xpos) < self._radius:
            self._activated = True
        return self._activated
