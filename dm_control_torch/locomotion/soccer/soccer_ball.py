"""The soccer ball, as names (counterpart of
``dm_control_tpu/locomotion/soccer/soccer_ball.py``).

A free sphere: the body ``<name>/body`` on the free joint
``<name>/body_root`` in a compiled match.  Its possession trackers (who
hit it last, interceptions) read contacts on the host, with composer's
host path (ROADMAP A5).
"""

from __future__ import annotations

_REGULATION_RADIUS = 0.117  # m
_REGULATION_MASS = 0.45  # kg
_DEFAULT_FRICTION = (0.7, 0.05, 0.04)  # (slide, spin, roll)


class SoccerBall:
    """A rolling ball of ``radius`` and ``mass``."""

    def __init__(self, radius=0.35, mass=0.045, friction=_DEFAULT_FRICTION,
                 name="soccer_ball"):
        self.name = name
        self.radius = radius
        self.mass = mass
        self.friction = tuple(friction)


def regulation_soccer_ball():
    """A FIFA-regulation-sized ball."""
    return SoccerBall(radius=_REGULATION_RADIUS, mass=_REGULATION_MASS,
                      friction=_DEFAULT_FRICTION, name="regulation_ball")
