"""Go-to-target task
(reference: dm_control/locomotion/tasks/go_to_target.py:28).

Counterpart of ``dm_control_tpu/locomotion/tasks/go_to_target.py``.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch import composer
from dm_control_torch.composer.observation.observable import Generic


class GoToTarget(composer.Task):
    """Walker is rewarded for reaching a moving target position."""

    def __init__(self, walker, arena, moving_target=False,
                 target_relative=False, distance_tolerance=1.0,
                 steps_before_moving_target=10,
                 physics_timestep=0.005, control_timestep=0.025):
        self._arena = arena
        self._walker = walker
        arena.add_free_entity(walker)
        self._moving_target = moving_target
        self._distance_tolerance = distance_tolerance
        self._steps_before_moving = steps_before_moving_target
        self._target_pos = np.zeros(2)
        self._reward_step_counter = 0
        walker.observables.enable_proprioception()

        def target_obs(physics):
            root = walker.root_xpos(physics)
            vec = np.array([self._target_pos[0] - root[0],
                            self._target_pos[1] - root[1], 0.0])
            return walker.transform_vec_to_egocentric_frame(physics, vec)

        self._task_observables = {
            "target": Generic(target_obs)}
        self._task_observables["target"].enabled = True
        self.set_timesteps(control_timestep, physics_timestep)

    @property
    def root_entity(self):
        return self._arena

    def _sample_target(self, random_state):
        lim = np.asarray(self._arena.size) * 0.7
        self._target_pos = random_state.uniform(-lim, lim)

    def initialize_episode(self, physics, random_state):
        self._sample_target(random_state)
        self._reward_step_counter = 0
        self._walker.set_pose(
            physics, position=[0, 0, 1.3],
            quaternion=[1, 0, 0, 0])

    def get_reward(self, physics):
        root = self._walker.root_xpos(physics)
        dist = np.linalg.norm(root[:2] - self._target_pos)
        if dist < self._distance_tolerance:
            reward = 1.0
            self._reward_step_counter += 1
        else:
            reward = 0.0
        return reward

    def after_step(self, physics, random_state):
        if (self._moving_target
                and self._reward_step_counter >= self._steps_before_moving):
            self._sample_target(random_state)
            self._reward_step_counter = 0
