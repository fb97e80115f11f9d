"""Floor arena (counterpart of
``dm_control_tpu/locomotion/arenas/floors.py``; reference:
dm_control/locomotion/arenas/floors.py:26)."""

from __future__ import annotations

from dm_control_torch.composer.arena import Arena


class Floor(Arena):
    """A flat plane with aligned world axes."""

    def _build(self, size=(8, 8), name="floor"):
        super()._build(name=name)
        self._size = size
        wb = self._mjcf_root.first("worldbody")
        # the default friction, like the reference's groundplane
        # (floors.py:77-82 sets no friction)
        self._ground_geom = wb.add(
            "geom", name="groundplane", type="plane",
            size=f"{size[0]} {size[1]} 0.25")

    @property
    def ground_geoms(self):
        return (self._ground_geom,)

    @property
    def size(self):
        return self._size
