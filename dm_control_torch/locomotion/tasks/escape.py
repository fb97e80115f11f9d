"""Escape task: leave a bowl-shaped starting area.

Reference: dm_control/locomotion/tasks/escape.py:29 — reward is the
distance of the walker's reward body from the origin relative to the
terrain size (linear tolerance), gated by an uprightness term.

Counterpart of ``dm_control_tpu/locomotion/tasks/escape.py``.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch import composer
from dm_control_torch.utils import rewards


class Escape(composer.Task):
    """Escape the arena (e.g. the Bowl heightfield)."""

    def __init__(self, walker, arena,
                 walker_spawn_position=(0, 0, 1.0),
                 walker_spawn_rotation=None,
                 upright_deviation_angle=30.0,
                 physics_timestep=0.005, control_timestep=0.025):
        self._arena = arena
        self._walker = walker
        arena.add_free_entity(walker)
        self._spawn_position = np.asarray(walker_spawn_position, float)
        self._spawn_rotation = walker_spawn_rotation
        self._deviation_angle = upright_deviation_angle
        walker.observables.enable_proprioception()
        self.set_timesteps(control_timestep, physics_timestep)

    @property
    def root_entity(self):
        return self._arena

    @property
    def _terrain_size(self):
        for e in self._arena.mjcf_model.iter():
            if e.tag == "hfield":
                return float(str(e.get("size")).split()[0])
        # plane-floored arena: use its half extent
        for e in self._arena.mjcf_model.iter():
            if e.tag == "geom" and e.get("type") == "plane":
                return float(str(e.get("size")).split()[0])
        return 10.0

    def initialize_episode(self, physics, random_state):
        quat = [1, 0, 0, 0]
        if self._spawn_rotation is not None:
            angle = self._spawn_rotation
            if callable(angle):
                angle = angle(random_state)
            quat = [np.cos(angle / 2), 0, 0, np.sin(angle / 2)]
        self._walker.set_pose(physics, position=self._spawn_position,
                              quaternion=quat)

    def _upright_reward(self, physics):
        """1 when the walker's z-axis is within deviation_angle of world
        up, shading to 0 (reference escape.py _upright_reward)."""
        zz = float(np.asarray(self._walker.root_xmat(physics))[2, 2])
        cos_limit = np.cos(np.deg2rad(self._deviation_angle))
        return float(rewards.tolerance(
            zz, bounds=(cos_limit, float("inf")),
            margin=1 + cos_limit, sigmoid="linear", value_at_margin=0))

    def get_reward(self, physics):
        size = self._terrain_size
        dist = float(np.linalg.norm(
            np.asarray(self._walker.root_xpos(physics))[:2]))
        escape = float(rewards.tolerance(
            dist, bounds=(size, float("inf")), margin=size,
            value_at_margin=0, sigmoid="linear"))
        return escape * self._upright_reward(physics)
