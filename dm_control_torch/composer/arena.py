"""Arena entities (counterpart of ``dm_control_tpu/composer/arena.py``;
reference: dm_control/composer/arena.py:26-43)."""

from __future__ import annotations

from dm_control_torch.composer.entity import Entity
from dm_control_torch.mjcf.element import Element


class Arena(Entity):
    """An empty arena with a worldbody to attach things into."""

    def _build(self, name="arena"):
        self._mjcf_root = Element("mujoco", {"model": name})
        self._mjcf_root.add("worldbody")

    def add_free_entity(self, entity):
        """Attaches an entity with root joints on its attachment frame
        (reference arena.py:37); entities may override
        ``create_root_joints`` (e.g. planar walkers)."""
        frame = self.attach(entity)
        if hasattr(entity, "create_root_joints"):
            entity.create_root_joints(frame)
        else:
            frame.children.insert(0, Element(
                "freejoint", {"name": frame.get("name") + "_root"},
                parent=frame))
        return frame


class Floor(Arena):
    """An arena with an infinite plane floor
    (reference locomotion/arenas/floors.py:26)."""

    def _build(self, size=(8, 8), name="floor"):
        super()._build(name=name)
        wb = self._mjcf_root.first("worldbody")
        wb.add("geom", name="groundplane", type="plane",
               size=f"{size[0]} {size[1]} 0.25")
