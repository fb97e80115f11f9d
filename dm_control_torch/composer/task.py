"""Composer task (counterpart of ``dm_control_tpu/composer/task.py``;
reference: dm_control/composer/task.py:36-311)."""

from __future__ import annotations

import abc
import collections


class Task(abc.ABC):
    """A task over a root entity, with the reference's hook structure."""

    @property
    @abc.abstractmethod
    def root_entity(self):
        """The entity whose mjcf model is compiled."""

    @property
    def observables(self):
        out = collections.OrderedDict()
        for entity in self.root_entity.iter_entities():
            out.update(entity.observables.as_dict())
        out.update(getattr(self, "_task_observables", {}))
        return out

    @property
    def control_timestep(self):
        return getattr(self, "_control_timestep", self.physics_timestep)

    @control_timestep.setter
    def control_timestep(self, value):
        self._control_timestep = value

    @property
    def physics_timestep(self):
        return getattr(self, "_physics_timestep", 0.002)

    @physics_timestep.setter
    def physics_timestep(self, value):
        self._physics_timestep = value

    def set_timesteps(self, control_timestep, physics_timestep):
        self._control_timestep = control_timestep
        self._physics_timestep = physics_timestep

    # -- hooks (reference task.py; called by Environment) -------------------

    def initialize_episode_mjcf(self, random_state):
        pass

    def after_compile(self, physics, random_state):
        pass

    def initialize_episode(self, physics, random_state):
        pass

    def before_step(self, physics, action, random_state):
        physics.set_control(action)

    def before_substep(self, physics, action, random_state):
        pass

    def after_substep(self, physics, random_state):
        pass

    def after_step(self, physics, random_state):
        pass

    @abc.abstractmethod
    def get_reward(self, physics):
        raise NotImplementedError

    def get_discount(self, physics):
        return 1.0

    def should_terminate_episode(self, physics):
        return False

    def action_spec(self, physics):
        return physics.action_spec()


class NullTask(Task):
    """A no-reward task over a single entity (reference task.py:311)."""

    def __init__(self, root_entity):
        self._root_entity = root_entity

    @property
    def root_entity(self):
        return self._root_entity

    def get_reward(self, physics):
        return 0.0
