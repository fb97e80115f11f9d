"""TwoTouch task: tap a target twice with a prescribed delay.

Reference: dm_control/locomotion/tasks/reach.py:38 — a state machine
PRE_TOUCH → TOUCHED_ONCE → TOUCHED_TWICE with a reward for the second
touch landing inside [touch_interval ± interval_tolerance], a timeout
penalty state, and target re-randomization after each trial.  The
reference uses hand-geom contact on a Rat/CMU walker; here activation is
the end-effector entering the target radius (the same convention as
props/target_sphere.py).

Counterpart of ``dm_control_tpu/locomotion/tasks/reach.py``.
"""

from __future__ import annotations

import collections
import enum

import numpy as np

from dm_control_torch import composer
from dm_control_torch.composer.observation.observable import Generic
from dm_control_torch.locomotion.props.target_sphere import TargetSphere

DEFAULT_PHYSICS_TIMESTEP = 0.005
DEFAULT_CONTROL_TIMESTEP = 0.025


class TwoTouchState(enum.IntEnum):
    PRE_TOUCH = 0
    TOUCHED_ONCE = 1
    TOUCHED_TWICE = 2  # success: window hit
    TOUCHED_TOO_SOON = 3
    NO_SECOND_TOUCH = 4


class TwoTouch(composer.Task):
    """Touch the target, wait ~touch_interval, touch it again."""

    def __init__(self, walker, arena,
                 target_type_rewards=(1.0,),
                 touch_interval=0.8,
                 interval_tolerance=0.1,
                 failure_timeout=1.2,
                 target_area=(1.0, 1.0),
                 z_height=0.14,
                 aliveness_reward=0.0,
                 randomize_spawn_rotation=True,
                 physics_timestep=DEFAULT_PHYSICS_TIMESTEP,
                 control_timestep=DEFAULT_CONTROL_TIMESTEP):
        self._walker = walker
        self._arena = arena
        arena.add_free_entity(walker)
        self._target = TargetSphere(radius=0.12, name="touch_target")
        arena.attach(self._target)
        self._target_type_rewards = tuple(target_type_rewards)
        self._touch_interval = touch_interval
        self._interval_tolerance = interval_tolerance
        self._failure_timeout = failure_timeout
        self._target_area = tuple(target_area)
        self._z_height = z_height
        self._aliveness_reward = aliveness_reward
        self._randomize_spawn_rotation = randomize_spawn_rotation
        self._state = TwoTouchState.PRE_TOUCH
        self._discount = 1.0
        walker.observables.enable_proprioception()
        self.set_timesteps(control_timestep, physics_timestep)

        self._task_observables = collections.OrderedDict()
        self._task_observables["task_logic"] = Generic(
            lambda _: np.array([int(self._state)]))

        def target_rel_pos(physics):
            hand = self._effector_pos(physics)
            tpos = physics.bind(self._target.attachment_frame).xpos
            return np.asarray(hand) - np.asarray(tpos)

        self._task_observables["target_rel_pos"] = Generic(target_rel_pos)
        for obs in self._task_observables.values():
            obs.enabled = True

    @property
    def root_entity(self):
        return self._arena

    @property
    def task_observables(self):
        return self._task_observables

    def _effector_pos(self, physics):
        names = self._walker.end_effector_body_names
        if names:
            return np.asarray(physics.named_field(
                "xpos", self._walker._prefixed(names[0])))
        return np.asarray(self._walker.root_xpos(physics))

    def _randomize_target(self, physics, random_state):
        pos = np.array([
            self._target_area[0] * random_state.uniform(-1.0, 1.0),
            self._target_area[1] * random_state.uniform(-1.0, 1.0),
            self._z_height])
        physics.bind(self._target.attachment_frame).pos = pos
        self._target.reset(physics)
        self._state = TwoTouchState.PRE_TOUCH
        self._first_touch_time = None
        self._timeout_until = None

    def initialize_episode(self, physics, random_state):
        quat = (1.0, 0.0, 0.0, 0.0)
        if self._randomize_spawn_rotation:
            yaw = random_state.uniform(0, 2 * np.pi)
            quat = (np.cos(yaw / 2), 0, 0, np.sin(yaw / 2))
        self._walker.set_pose(physics, position=(0, 0, 0.5),
                              quaternion=quat)
        self._randomize_target(physics, random_state)
        self._discount = 1.0
        self._step_reward = 0.0

    def after_step(self, physics, random_state):
        self._step_reward = 0.0
        now = float(physics.time())
        if self._timeout_until is not None:
            if now >= self._timeout_until:
                self._randomize_target(physics, random_state)
            return
        hand = self._effector_pos(physics)
        touching = self._target.distance(physics, hand) \
            < self._target.radius
        if self._state == TwoTouchState.PRE_TOUCH and touching:
            self._state = TwoTouchState.TOUCHED_ONCE
            self._first_touch_time = now
            self._step_reward += self._target_type_rewards[0]
            self._was_touching = True
        elif self._state == TwoTouchState.TOUCHED_ONCE:
            dt = now - self._first_touch_time
            lo = self._touch_interval - self._interval_tolerance
            hi = self._touch_interval + self._interval_tolerance
            if touching and not self._was_touching:
                if lo <= dt <= hi:
                    self._state = TwoTouchState.TOUCHED_TWICE
                    self._step_reward += 2.0 * self._target_type_rewards[0]
                else:
                    self._state = TwoTouchState.TOUCHED_TOO_SOON
                self._timeout_until = now + self._failure_timeout
            elif dt > hi:
                self._state = TwoTouchState.NO_SECOND_TOUCH
                self._timeout_until = now + self._failure_timeout
            self._was_touching = touching

    def get_reward(self, physics):
        return self._aliveness_reward + self._step_reward

    def get_discount(self, physics):
        return self._discount
