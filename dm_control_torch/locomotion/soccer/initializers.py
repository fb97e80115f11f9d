"""Soccer episode initializers (counterpart of
``dm_control_tpu/locomotion/soccer/initializers.py``; reference:
dm_control/locomotion/soccer/initializers.py)."""

from __future__ import annotations

import abc

import numpy as np

_INIT_BALL_Z = 0.5
_SPAWN_RATIO = 0.6


class Initializer(abc.ABC):

    @abc.abstractmethod
    def __call__(self, task, physics, random_state):
        """Initializes an episode of ``task``."""


class UniformInitializer(Initializer):
    """Draws the ball and the walkers uniformly over the spawn box, again
    while one touches another (reference initializers.py:32-127)."""

    def __init__(self, spawn_ratio=_SPAWN_RATIO, init_ball_z=_INIT_BALL_Z,
                 max_collision_avoidance_retries=100):
        self._spawn_ratio = spawn_ratio
        self._init_ball_z = init_ball_z
        self._max_retries = max_collision_avoidance_retries

    def _initialize_ball(self, ball, spawn_range, physics, random_state):
        x, y = random_state.uniform(-spawn_range, spawn_range)
        ball.set_pose(physics, [x, y, self._init_ball_z])
        ball.set_velocity(physics, velocity=0.0, angular_velocity=0.0)

    def _initialize_walker(self, walker, spawn_range, physics,
                           random_state):
        """Draws (x, y), then a yaw.  An ant's or a humanoid's free root
        takes the drawn position, then the yaw turns its orientation
        (``shift_pose`` reads the pose after a forward, since
        ``set_pose`` marks the physics dirty) and its velocity is zeroed.
        A BoxHead's ``set_pose`` leaves the physics clean, so each pose
        read is the last forward's, and its orientation comes from its
        steer joint, which the yaw leaves as it is; it has no free joint
        to zero (as in the JAX package)."""
        if hasattr(walker, "reinitialize_pose"):
            walker.reinitialize_pose(physics, random_state)
        x, y = random_state.uniform(-spawn_range, spawn_range)
        (_, _, z), quat = walker.get_pose(physics)
        walker.set_pose(physics, [x, y, float(z)], np.asarray(quat))
        rotation = random_state.uniform(-np.pi, np.pi)
        quat = [np.cos(rotation / 2), 0, 0, np.sin(rotation / 2)]
        walker.shift_pose(physics, quaternion=quat)
        try:
            walker.set_velocity(physics, velocity=0.0,
                                angular_velocity=0.0)
        except ValueError:
            pass  # planar walkers (BoxHead) have slide roots, not free

    def _initialize_entities(self, task, physics, random_state):
        spawn_range = np.asarray(task.arena.size) * self._spawn_ratio
        self._initialize_ball(task.ball, spawn_range, physics, random_state)
        for player in task.players:
            self._initialize_walker(player.walker, spawn_range, physics,
                                    random_state)

    def _entity_geom_ids(self, task, physics):
        m = physics.model
        ball_ids = {gid for name, gid in m.names.geom.items()
                    if name.startswith(task.ball.name)}
        walker_ids = []
        for player in task.players:
            prefix = player.walker.name
            walker_ids.append({gid for name, gid in m.names.geom.items()
                               if name.startswith(prefix)})
        return ball_ids, walker_ids

    @staticmethod
    def _penetrating(physics):
        """(geom1, geom2) of each contact with a negative distance: one
        copy of the distances from the device."""
        c = physics.data.contact
        dist = c.dist.cpu().numpy()
        g1, g2 = np.asarray(c.geom1), np.asarray(c.geom2)
        rows = np.where(dist < 0)[0]
        return list(zip(g1[rows].tolist(), g2[rows].tolist()))

    @staticmethod
    def _has_relevant_contact(pairs, geom_ids, all_ids):
        other = all_ids - geom_ids
        for a, b in pairs:
            if (a in geom_ids and b in other) or (
                    b in geom_ids and a in other):
                return True
        return False

    def __call__(self, task, physics, random_state):
        ball_ids, walker_ids = self._entity_geom_ids(task, physics)
        all_ids = set(ball_ids)
        for w in walker_ids:
            all_ids |= w
        for _ in range(self._max_retries + 1):
            self._initialize_entities(task, physics, random_state)
            physics.forward()  # the contacts of the drawn poses
            pairs = self._penetrating(physics)
            retry = self._has_relevant_contact(pairs, ball_ids, all_ids)
            if not retry:
                retry = any(self._has_relevant_contact(pairs, w, all_ids)
                            for w in walker_ids)
            if not retry:
                return
        raise RuntimeError(
            "UniformInitializer: `max_retries` (%d) exceeded."
            % self._max_retries)
