"""Standard manipulation arena (counterpart of
``dm_control_tpu/manipulation/shared/arenas.py``; reference:
dm_control/manipulation/shared/arenas.py:24-56)."""

from __future__ import annotations

from dm_control_torch import composer
from dm_control_torch.mjcf.element import Element


class Standard(composer.Arena):
    """Flat ground with a pedestal area for tabletop manipulation."""

    def _build(self, name="arena"):
        self._mjcf_root = Element("mujoco", {"model": name})
        self._mjcf_root.add(
            "option", timestep="0.002", cone="pyramidal")
        wb = self._mjcf_root.add("worldbody")
        wb.add("geom", name="ground", type="plane", size="2 2 0.1",
               friction="1 0.005 0.0001")

    def attach_offset(self, entity, offset, attach_site=None):
        """Attaches an entity with a position offset on its frame
        (reference arenas.py:44).

        The offset composes with the frame's own pos: attach() may
        collapse a single-root-body child into the frame, so its
        original position must be preserved."""
        frame = self.attach(entity, attach_site=attach_site)
        own = [float(v) for v in str(frame.get("pos", "0 0 0")).split()]
        frame.attrib["pos"] = " ".join(
            str(o + f) for o, f in zip(offset, own))
        return frame
