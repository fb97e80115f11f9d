"""The soccer pitch arena (counterpart of
``dm_control_tpu/locomotion/soccer/pitch.py``; reference:
dm_control/locomotion/soccer/pitch.py:104-724: goal detectors, the field,
``RandomizedPitch`` and the mini-football constants).

Goals and the field are axis-aligned boxes: a ball inside a goal's box is
a goal for the other team, a ball outside the field is off court.  The
detectors read the ball's position from the physics on the host; the
batched hooks (``soccer/task.py``) test the same boxes on the device.
``RandomizedPitch`` draws its size every episode in
``initialize_episode_mjcf`` and rewrites its tree, which the environment
compiles again (``recompile_mjcf_every_episode``).
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.composer.arena import Arena
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
    """An axis-aligned box, ``lower`` to ``upper`` (bounds inside), that
    detects the registered entities inside it."""

    def __init__(self, lower, upper):
        self.lower = np.asarray(lower, float)
        self.upper = np.asarray(upper, float)
        self._entities = []
        self._detected = []

    def resize(self, lower, upper):
        self.lower = np.asarray(lower, float)
        self.upper = np.asarray(upper, float)

    @property
    def mid(self):
        return (self.lower + self.upper) / 2.0

    def register_entities(self, *entities):
        for e in entities:
            if e not in self._entities:
                self._entities.append(e)

    @property
    def detected_entities(self):
        return list(self._detected)

    def detect(self, point) -> bool:
        p = np.asarray(point)[:len(self.lower)]
        return bool(np.all(p >= self.lower) and np.all(p <= self.upper))

    def update(self, physics):
        self._detected = [
            e for e in self._entities
            if self.detect(np.asarray(e.get_pose(physics)[0]))]


class Goal(_Region):
    """A goal mouth owned by ``team``: a ball inside it is a goal for the
    other team (reference pitch.py:201,606-612)."""

    def __init__(self, lower, upper, team):
        super().__init__(lower, upper)
        self.team = team


class Field(_Region):
    """The in-bounds region of play, (x, y): it detects the entities
    outside it (off court)."""

    def update(self, physics):
        self._detected = [
            e for e in self._entities
            if not self.detect(np.asarray(e.get_pose(physics)[0]))]


class Pitch(Arena):
    """A field of half-size ``size`` with perimeter walls and a goal at
    each end."""

    def _build(self, size=_DEFAULT_PITCH_SIZE, goal_size=None,
               field_box=False, name="pitch"):
        super()._build(name=name)
        self._size = tuple(size)
        self._goal_size = goal_size
        self._has_field_box = field_box
        wb = self._mjcf_root.first("worldbody")
        self._ground_geom = wb.add(
            "geom", name="field", type="plane",
            size=f"{size[0]} {size[1]} 0.25",
            friction="0.7 0.005 0.0001")
        self._wall_elems = []
        for i, (pos, zaxis, sz) in enumerate(self._wall_layout()):
            self._wall_elems.append(wb.add(
                "geom", name=f"wall_{i}", type="plane",
                pos=" ".join(map(str, pos)),
                zaxis=" ".join(map(str, zaxis)),
                size=" ".join(map(str, sz))))
        gx, gy, gz = self._get_goal_size()
        self._home_goal = Goal(
            lower=(-size[0], -gy, 0), upper=(-size[0] + 2 * gx, gy, 2 * gz),
            team=Team.HOME)
        self._away_goal = Goal(
            lower=(size[0] - 2 * gx, -gy, 0), upper=(size[0], gy, 2 * gz),
            team=Team.AWAY)
        self._field = Field(
            lower=(-size[0] + 2 * gx, -size[1] + 2 * gx),
            upper=(size[0] - 2 * gx, size[1] - 2 * gx))
        self._goal_site_elems = []
        for side, x in ((Team.HOME, -size[0] + gx),
                        (Team.AWAY, size[0] - gx)):
            self._goal_site_elems.append(wb.add(
                "site", name=f"{side.name.lower()}_goal", type="box",
                pos=f"{x} 0 {gz}", size=f"{gx} {gy} {gz}", group="4"))

    def _wall_layout(self):
        sx, sy = self._size
        return [((0, sy, 0.5), (0, -1, 0), (sx, 1, 0.5)),
                ((0, -sy, 0.5), (0, 1, 0), (sx, 1, 0.5)),
                ((sx, 0, 0.5), (-1, 0, 0), (sy, 1, 0.5)),
                ((-sx, 0, 0.5), (1, 0, 0), (sy, 1, 0.5))]

    def _get_goal_size(self):
        """(depth, half-width, half-height), from the pitch's size unless
        pinned; the depth is capped at 1/12 of the pitch's half-length, as
        in the JAX package (reference pitch.py:547-556 uses
        ``_SIDE_WIDTH / 2``)."""
        if self._goal_size is not None:
            return tuple(self._goal_size)
        depth = min(_SIDE_WIDTH / 2, self._size[0] / 12.0)
        return (depth, self._size[1] * _DEFAULT_GOAL_LENGTH_RATIO, depth)

    # -- registration and detection (reference pitch.py:557-612) ------------

    def register_ball(self, ball):
        self._home_goal.register_entities(ball)
        self._away_goal.register_entities(ball)
        self._field.register_entities(ball)

    def update_detection(self, physics):
        self._home_goal.update(physics)
        self._away_goal.update(physics)
        self._field.update(physics)

    def detected_goal(self):
        """The team that scored, if any: a ball inside the home goal is
        the away team's (reference pitch.py:599-605)."""
        if self._home_goal.detected_entities:
            return Team.AWAY
        if self._away_goal.detected_entities:
            return Team.HOME
        return None

    def detected_off_court(self):
        return self._field.detected_entities

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

    @property
    def ground_geom(self):
        return self._ground_geom


class RandomizedPitch(Pitch):
    """A pitch whose size is drawn every episode between ``min_size`` and
    ``max_size`` (reference pitch.py:605-706): built at ``max_size``."""

    def _build(self, min_size=(8, 6), max_size=(16, 12), randomizer=None,
               keep_aspect_ratio=False, goal_size=None, field_box=False,
               name="randomized_pitch", **kwargs):
        self._min_size = tuple(min_size)
        self._max_size = tuple(max_size)
        self._randomizer = randomizer
        self._keep_aspect_ratio = keep_aspect_ratio
        super()._build(size=max_size, goal_size=goal_size,
                       field_box=field_box, name=name, **kwargs)

    def initialize_episode_mjcf(self, random_state):
        """Draws the length ratio, then the width ratio (the length's
        again with ``keep_aspect_ratio``), and rewrites the ground, the
        walls, the goal sites and the detectors to the drawn size."""
        super().initialize_episode_mjcf(random_state)
        if self._randomizer is not None:
            len_ratio = self._randomizer(random_state=random_state)
            wid_ratio = (len_ratio if self._keep_aspect_ratio
                         else self._randomizer(random_state=random_state))
        else:
            len_ratio = random_state.uniform()
            wid_ratio = (len_ratio if self._keep_aspect_ratio
                         else random_state.uniform())
        min_len, min_wid = self._min_size
        max_len, max_wid = self._max_size
        self._size = (min_len + len_ratio * (max_len - min_len),
                      min_wid + wid_ratio * (max_wid - min_wid))
        sx, sy = self._size
        self._ground_geom.attrib["size"] = f"{sx} {sy} 0.25"
        for elem, (pos, _, sz) in zip(self._wall_elems,
                                      self._wall_layout()):
            elem.attrib["pos"] = " ".join(map(str, pos))
            elem.attrib["size"] = " ".join(map(str, sz))
        gx, gy, gz = self._get_goal_size()
        self._home_goal.resize((-sx, -gy, 0), (-sx + 2 * gx, gy, 2 * gz))
        self._away_goal.resize((sx - 2 * gx, -gy, 0), (sx, gy, 2 * gz))
        self._field.resize((-sx + 2 * gx, -sy + 2 * gx),
                           (sx - 2 * gx, sy - 2 * gx))
        for elem, (_, x) in zip(self._goal_site_elems,
                                ((Team.HOME, -sx + gx),
                                 (Team.AWAY, sx - gx))):
            elem.attrib["pos"] = f"{x} 0 {gz}"
            elem.attrib["size"] = f"{gx} {gy} {gz}"
