"""The soccer pitch as geometry (counterpart of
``dm_control_tpu/locomotion/soccer/pitch.py``).

Goals and the field are axis-aligned boxes: a ball inside a goal's box is
a goal for the other team.  The pitch's compiled model (ground, walls)
is a checked-in asset; a ``RandomizedPitch``, whose size changes every
episode, needs a compile per episode, which the port cannot do yet
(ROADMAP A9).
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.locomotion.soccer.team import Team

_DEFAULT_PITCH_SIZE = (12, 9)
_SIDE_WIDTH = 32.0 / 6.0
_DEFAULT_GOAL_LENGTH_RATIO = 0.33  # goal length / pitch width

_GOAL_LENGTH = 3.66
_GOAL_SIDE = 1.22

MINI_FOOTBALL_MIN_AREA_PER_HUMANOID = 100.0
MINI_FOOTBALL_MAX_AREA_PER_HUMANOID = 350.0
MINI_FOOTBALL_GOAL_SIZE = (_GOAL_SIDE / 2, _GOAL_LENGTH / 2, _GOAL_SIDE / 2)


class _Region:
    """An axis-aligned box, ``lower`` to ``upper`` (bounds included)."""

    def __init__(self, lower, upper):
        self.lower = np.asarray(lower, float)
        self.upper = np.asarray(upper, float)

    @property
    def mid(self):
        return (self.lower + self.upper) / 2.0

    def detect(self, point) -> bool:
        p = np.asarray(point)[:len(self.lower)]
        return bool(np.all(p >= self.lower) and np.all(p <= self.upper))


class Goal(_Region):
    """A goal mouth owned by ``team``: a ball inside it is a goal for the
    other team."""

    def __init__(self, lower, upper, team):
        super().__init__(lower, upper)
        self.team = team


class Field(_Region):
    """The in-bounds region of play, (x, y)."""


class Pitch:
    """A field of half-size ``size`` with a goal at each end."""

    def __init__(self, size=_DEFAULT_PITCH_SIZE, goal_size=None,
                 field_box=False, name="pitch"):
        # the field box and the name leave the compiled model as it is
        del field_box, name
        self._size = tuple(size)
        self._goal_size = goal_size
        self._layout_regions()

    def _layout_regions(self):
        sx, sy = self._size
        gx, gy, gz = self._get_goal_size()
        self._home_goal = Goal(lower=(-sx, -gy, 0),
                               upper=(-sx + 2 * gx, gy, 2 * gz),
                               team=Team.HOME)
        self._away_goal = Goal(lower=(sx - 2 * gx, -gy, 0),
                               upper=(sx, gy, 2 * gz), team=Team.AWAY)
        self._field = Field(lower=(-sx + 2 * gx, -sy + 2 * gx),
                            upper=(sx - 2 * gx, sy - 2 * gx))

    def _get_goal_size(self):
        """(depth, half-width, half-height), from the pitch's size unless
        pinned; the depth is capped at 1/12 of the pitch's half-length."""
        if self._goal_size is not None:
            return tuple(self._goal_size)
        depth = min(_SIDE_WIDTH / 2, self._size[0] / 12.0)
        return (depth, self._size[1] * _DEFAULT_GOAL_LENGTH_RATIO, depth)

    @property
    def size(self):
        return self._size

    @property
    def home_goal(self):
        return self._home_goal

    @property
    def away_goal(self):
        return self._away_goal

    @property
    def field(self):
        return self._field


class RandomizedPitch(Pitch):
    """A pitch whose size is drawn every episode between ``min_size`` and
    ``max_size``.  Its geometry here is that of ``max_size``; each episode
    needs a compile of its own (ROADMAP A9)."""

    def __init__(self, min_size=(8, 6), max_size=(16, 12), randomizer=None,
                 keep_aspect_ratio=False, goal_size=None, field_box=False,
                 name="randomized_pitch"):
        del min_size, randomizer, keep_aspect_ratio
        super().__init__(size=max_size, goal_size=goal_size,
                         field_box=field_box, name=name)
