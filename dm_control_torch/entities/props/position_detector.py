"""A box-shaped region that detects positions inside it (counterpart of
``dm_control_tpu/entities/props/position_detector.py``; reference:
dm_control/entities/props/position_detector.py)."""

from __future__ import annotations

import numpy as np

from dm_control_torch import composer
from dm_control_torch.mjcf.element import Element


class PositionDetector(composer.Entity):
    """Detects which positions lie inside an axis-aligned box around its
    body."""

    def _build(self, pos, size, name="detector"):
        self._pos = np.asarray(pos, float)
        self._size = np.asarray(size, float)
        root = Element("mujoco", {"model": name})
        wb = root.add("worldbody")
        body = wb.add("body", name="body",
                      pos=" ".join(str(p) for p in pos))
        body.add("site", name="region", type="box",
                 size=" ".join(str(s) for s in size), group="4")
        self._mjcf_root = root
        self._detected = []

    @property
    def detected(self):
        return tuple(self._detected)

    def initialize_episode(self, physics, random_state):
        self._detected = []

    def update(self, physics, entity_positions):
        """The indices of ``entity_positions`` inside the region, which
        ``detected`` keeps until the next update."""
        center = self.site_pos(physics)
        inside = []
        for i, p in enumerate(entity_positions):
            if np.all(np.abs(np.asarray(p) - center) <= self._size):
                inside.append(i)
        self._detected = inside
        return inside

    def site_pos(self, physics):
        """The world position of the detector's attachment frame."""
        return np.asarray(physics.named_field(
            "xpos", self.attachment_frame.get("name")))
