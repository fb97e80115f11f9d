"""The soccer ball entity (counterpart of
``dm_control_tpu/locomotion/soccer/soccer_ball.py``; reference:
dm_control/locomotion/soccer/soccer_ball.py:50-262: hit, interception and
distance tracking, and ``regulation_soccer_ball``).

A free sphere: the body ``<name>/body`` under the attachment frame
``<name>`` with its free joint ``<name>_root``.  The possession trackers
are fed by the task (``soccer/task.py::_update_ball_contacts``) from the
contacts on the host.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch import composer
from dm_control_torch.composer.observation.observable import Generic
from dm_control_torch.mjcf.element import Element

# regulation sizes (reference soccer_ball.py:28-35)
_REGULATION_RADIUS = 0.117  # m
_REGULATION_MASS = 0.45  # kg
_DEFAULT_FRICTION = (0.7, 0.05, 0.04)  # (slide, spin, roll)


def regulation_soccer_ball():
    """A FIFA-regulation-sized ball (reference soccer_ball.py:38-47)."""
    return SoccerBall(radius=_REGULATION_RADIUS, mass=_REGULATION_MASS,
                      friction=_DEFAULT_FRICTION, name="regulation_ball")


class SoccerBall(composer.Entity):
    """A rolling ball with contact-based possession tracking."""

    def _build(self, radius=0.35, mass=0.045, friction=_DEFAULT_FRICTION,
               name="soccer_ball"):
        root = Element("mujoco", {"model": name})
        wb = root.add("worldbody")
        body = wb.add("body", name="body", pos=f"0 0 {radius}")
        self._geom_elem = body.add(
            "geom", name="geom", type="sphere", size=str(radius),
            mass=str(mass), condim="6", priority="1",
            friction=" ".join(str(f) for f in friction))
        self._mjcf_root = root
        self._radius = radius
        self.initialize_entity_trackers()

    def _build_observables(self):
        return _BallObservables(self)

    @property
    def radius(self):
        return self._radius

    @property
    def geom(self):
        return self._geom_elem

    @property
    def last_hit(self):
        """The player that last touched the ball."""
        return self._last_hit

    @property
    def hit(self):
        return self._hit

    @property
    def repossessed(self):
        return self._repossessed

    @property
    def intercepted(self):
        return self._intercepted

    @property
    def dist_between_last_hits(self):
        """How far the ball went between the last two player contacts
        (reference soccer_ball.py:172-188)."""
        return self._dist_between_last_hits

    def register_player(self, player):
        pass  # the task finds the players' geoms by name

    def initialize_entity_trackers(self):
        self._last_hit = None
        self._hit = False
        self._repossessed = False
        self._intercepted = False
        self._pos_at_last_hit = None
        self._dist_between_last_hits = None

    def initialize_episode(self, physics, random_state):
        self.initialize_entity_trackers()

    def clear_step_flags(self):
        """Clears the flags of one control step; ``last_hit`` stays."""
        self._hit = False
        self._repossessed = False
        self._intercepted = False

    def update_hit(self, player, teammate: bool, position=None):
        """A contact of ``player`` (``teammate`` of the last hitter) with
        the ball at ``position``."""
        self._hit = True
        if position is not None:
            pos = np.asarray(position, float)
            if self._pos_at_last_hit is not None:
                self._dist_between_last_hits = float(
                    np.linalg.norm(pos - self._pos_at_last_hit))
            self._pos_at_last_hit = pos
        if self._last_hit is not player:
            self._repossessed = True
            if self._last_hit is not None and not teammate:
                self._intercepted = True
        self._last_hit = player

    # -- kinematics ----------------------------------------------------------

    def _root_dofadr(self, physics):
        m = physics.model
        jname = self.attachment_frame.get("name") + "_root"
        return int(m.jnt_dofadr[m.names.joint[jname]])

    def position(self, physics):
        return np.asarray(physics.named_field(
            "xpos", self.attachment_frame.get("name")))

    def linear_velocity(self, physics):
        a = self._root_dofadr(physics)
        return physics.data.qvel[a:a + 3].cpu().numpy()

    def angular_velocity(self, physics):
        a = self._root_dofadr(physics)
        return physics.data.qvel[a + 3:a + 6].cpu().numpy()


class _BallObservables(composer.Observables):
    """Position and velocity observables (reference
    soccer_ball.py:191-226)."""

    def _build(self):
        super()._build()
        ball = self._entity
        self.add_observable("position", Generic(ball.position))
        self.add_observable("linear_velocity",
                            Generic(ball.linear_velocity))
        self.add_observable("angular_velocity",
                            Generic(ball.angular_velocity))

    @property
    def position(self):
        return self["position"]

    @property
    def linear_velocity(self):
        return self["linear_velocity"]

    @property
    def angular_velocity(self):
        return self["angular_velocity"]
