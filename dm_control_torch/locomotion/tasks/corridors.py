"""Corridor locomotion task
(reference: dm_control/locomotion/tasks/corridors.py:25).

Counterpart of ``dm_control_tpu/locomotion/tasks/corridors.py``.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch import composer


class RunThroughCorridor(composer.Task):
    """Reward proportional to forward velocity along the corridor."""

    def __init__(self, walker, arena, walker_spawn_position=(0.5, 0, 0),
                 walker_spawn_rotation=None, target_velocity=3.0,
                 contact_termination=True, terminate_at_height=-0.5,
                 physics_timestep=0.005, control_timestep=0.025):
        self._arena = arena
        self._walker = walker
        arena.add_free_entity(walker)
        self._spawn_position = np.asarray(walker_spawn_position, float)
        self._spawn_rotation = walker_spawn_rotation
        self._target_velocity = target_velocity
        self._terminate_at_height = terminate_at_height
        self._contact_termination = contact_termination
        walker.observables.enable_proprioception()
        self.set_timesteps(control_timestep, physics_timestep)
        self._last_x = 0.0
        self._failure = False

    @property
    def root_entity(self):
        return self._arena

    def initialize_episode(self, physics, random_state):
        quat = [1, 0, 0, 0]
        if self._spawn_rotation is not None:
            from dm_control_torch.composer.variation.base import evaluate

            angle = evaluate(self._spawn_rotation,
                             random_state=random_state)
            quat = [np.cos(angle / 2), 0, 0, np.sin(angle / 2)]
        pos = self._spawn_position.copy()
        if pos[2] == 0:
            pos[2] = 1.3
        self._walker.set_pose(physics, position=pos, quaternion=quat)
        self._last_x = pos[0]
        self._failure = False

    def get_reward(self, physics):
        root = self._walker.root_xpos(physics)
        dt = self.control_timestep
        vel = (root[0] - self._last_x) / dt
        self._last_x = root[0]
        return float(np.clip(vel / self._target_velocity, -1.0, 1.0))

    def after_step(self, physics, random_state):
        root = self._walker.root_xpos(physics)
        if root[2] < self._terminate_at_height:
            self._failure = True

    def should_terminate_episode(self, physics):
        return self._failure

    def get_discount(self, physics):
        return 0.0 if self._failure else 1.0
