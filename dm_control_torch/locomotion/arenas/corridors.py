"""Corridor arenas (reference: dm_control/locomotion/arenas/corridors.py).

The layout is drawn once, when the arena is built, from the
``random_state`` given or numpy's global state: the JAX package's
behaviour (upstream dm_control redraws it every episode).

Counterpart of ``dm_control_tpu/locomotion/arenas/corridors.py``.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.composer.arena import Arena
from dm_control_torch.composer.variation.base import evaluate


class EmptyCorridor(Arena):
    """A corridor bounded by two side walls."""

    def _build(self, corridor_width=4, corridor_length=40,
               visible_side_planes=False, name="empty_corridor"):
        super()._build(name=name)
        self._corridor_width = corridor_width
        self._corridor_length = corridor_length
        wb = self._mjcf_root.first("worldbody")
        wb.add("geom", name="ground", type="plane",
               size=f"{corridor_length} {corridor_width} 0.25",
               pos=f"{corridor_length / 2 - 1} 0 0")
        half_w = corridor_width / 2
        for side, y in (("left", half_w), ("right", -half_w)):
            wb.add("geom", name=f"{side}_wall", type="plane",
                   zaxis=f"0 {-np.sign(y)} 0",
                   size=f"{corridor_length} 2 0.5",
                   pos=f"{corridor_length / 2 - 1} {y} 2")

    @property
    def corridor_length(self):
        return self._corridor_length

    @property
    def corridor_width(self):
        return self._corridor_width


class GapsCorridor(EmptyCorridor):
    """A corridor of platforms separated by gaps
    (reference corridors.py GapsCorridor)."""

    def _build(self, platform_length=1.0, gap_length=0.5, corridor_width=4,
               corridor_length=40, ground_rgba=(0.5, 0.5, 0.5, 1),
               name="gaps_corridor", random_state=None):
        Arena._build(self, name=name)
        self._corridor_width = corridor_width
        self._corridor_length = corridor_length
        rng = random_state or np.random
        wb = self._mjcf_root.first("worldbody")
        # start platform
        wb.add("geom", name="start_platform", type="box",
               size="2 {} 0.5".format(corridor_width / 2), pos="-1 0 -0.5")
        x = 1.0
        i = 0
        while x < corridor_length:
            plat = evaluate(platform_length, random_state=rng)
            gap = evaluate(gap_length, random_state=rng)
            wb.add("geom", name=f"platform_{i}", type="box",
                   size=f"{plat / 2} {corridor_width / 2} 0.5",
                   pos=f"{x + plat / 2} 0 -0.5")
            x += plat + gap
            i += 1


class WallsCorridor(EmptyCorridor):
    """A corridor with alternating wall obstacles
    (reference corridors.py WallsCorridor)."""

    def _build(self, wall_gap=2.5, wall_width=2.5, wall_height=2.0,
               corridor_width=4, corridor_length=40, swap_wall_side=True,
               name="walls_corridor", random_state=None):
        super()._build(corridor_width=corridor_width,
                       corridor_length=corridor_length, name=name)
        rng = random_state or np.random
        wb = self._mjcf_root.first("worldbody")
        x = 3.0
        side = 1
        i = 0
        while x < corridor_length - 2:
            gap = evaluate(wall_gap, random_state=rng)
            width = evaluate(wall_width, random_state=rng)
            y = side * (corridor_width / 2 - width / 2)
            wb.add("geom", name=f"wall_{i}", type="box",
                   size=f"0.1 {width / 2} {wall_height / 2}",
                   pos=f"{x} {y} {wall_height / 2}")
            if swap_wall_side:
                side = -side
            x += gap
            i += 1
