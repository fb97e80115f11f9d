"""Teams and players of a match (counterpart of
``dm_control_tpu/locomotion/soccer/team.py``)."""

from __future__ import annotations

import collections
import enum


class Team(enum.Enum):
    HOME = 0
    AWAY = 1


RGBA_BLUE = [0.1, 0.1, 0.8, 1.0]
RGBA_RED = [0.8, 0.1, 0.1, 1.0]


Player = collections.namedtuple("Player", ["team", "walker"])
