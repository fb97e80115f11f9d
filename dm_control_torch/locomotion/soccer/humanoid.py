"""The CMU humanoid as a soccer player (counterpart of
``dm_control_tpu/locomotion/soccer/humanoid.py``; reference:
dm_control/locomotion/soccer/humanoid.py:15-226).

The reference dresses the walker in a jersey texture; as in the JAX
package, ``Visual.JERSEY`` tints the torso's geoms in the team colour
instead (the same team signal, no mesh assets).
"""

from __future__ import annotations

import enum

from dm_control_torch.locomotion.walkers.cmu_humanoid import (
    CMUHumanoidPositionControlled,
)

_MAX_WALKER_ID = 10
_INVALID_WALKER_ID = (
    "`walker_id` must be in [0, {}], got: {{}}.".format(_MAX_WALKER_ID))

#: the torso and upper-body geoms the jersey tints (reference
#: humanoid.py ``_INTERIOR_GEOMS``)
_JERSEY_GEOMS = frozenset({
    "lowerback", "upperback", "thorax", "lclavicle", "rclavicle",
    "lowerneck", "lhumerus", "rhumerus",
})


class Humanoid(CMUHumanoidPositionControlled):
    """A position-controlled CMU humanoid marked for its team."""

    class Visual(enum.Enum):
        GEOM = 1
        JERSEY = 2

    def _build(self, visual=None, marker_rgba=None, walker_id=None,
               initializer=None, name="walker"):
        visual = visual or Humanoid.Visual.GEOM
        if not isinstance(visual, Humanoid.Visual):
            raise ValueError("`visual` must be one of `Humanoid.Visual`.")
        if marker_rgba is not None and len(marker_rgba) != 4:
            raise ValueError(
                "`marker_rgba` must be a sequence of length 4.")
        if walker_id is None and visual != Humanoid.Visual.GEOM:
            raise ValueError("`walker_id` must be set unless `visual` is"
                             " set to `Visual.GEOM`.")
        if walker_id is not None and not 0 <= walker_id <= _MAX_WALKER_ID:
            raise ValueError(_INVALID_WALKER_ID.format(walker_id))
        self._initializer = initializer
        self._walker_id = walker_id
        self._visual = visual
        super()._build(name=name)
        if marker_rgba is not None:
            rgba = list(marker_rgba)
            if visual != Humanoid.Visual.JERSEY:
                rgba[-1] = 0.7
            rgba_str = " ".join(str(v) for v in rgba)
            for geom in self._mjcf_root.find_all("geom"):
                gname = geom.get("name") or ""
                if (visual == Humanoid.Visual.GEOM
                        or gname.split("/")[-1] in _JERSEY_GEOMS):
                    geom.attrib["rgba"] = rgba_str

    @property
    def walker_id(self):
        return self._walker_id

    @property
    def marker_geoms(self):
        return [g for g in self._mjcf_root.find_all("geom")
                if (g.get("name") or "").split("/")[-1] in _JERSEY_GEOMS]

    def reinitialize_pose(self, physics, random_state):
        """The initializer's pose where one was given, else upright at the
        present position (``Walker.reinitialize_pose``)."""
        if self._initializer is not None:
            self._initializer.initialize_pose(physics, self, random_state)
        else:
            super().reinitialize_pose(physics, random_state)
