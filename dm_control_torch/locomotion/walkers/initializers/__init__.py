"""Walker pose initializers (counterpart of
``dm_control_tpu/locomotion/walkers/initializers/__init__.py``; reference:
dm_control/locomotion/walkers/initializers/__init__.py)."""

from __future__ import annotations

import abc
import collections

import numpy as np

UprightPose = collections.namedtuple("UprightPose",
                                     ("qpos", "xpos", "xquat"))


class WalkerInitializer(abc.ABC):
    """Initializes a walker's pose at episode start."""

    @abc.abstractmethod
    def initialize_pose(self, physics, walker, random_state):
        """Sets the walker's pose."""


def _reset_walker_joints(physics, walker, qpos=None):
    """Writes the walker's own (non-root) joints' qpos, in address order:
    ``qpos`` where given, else the model's reference pose ``qpos0``."""
    m = physics.model
    prefix = walker.name + "/"
    addrs = sorted(int(m.jnt_qposadr[j]) for jname, j in m.names.joint.items()
                   if jname.startswith(prefix)
                   and not jname.endswith("_root"))
    if qpos is None:
        values = m.qpos0[addrs].cpu().numpy()
    else:
        values = np.asarray(qpos, float).ravel()[:len(addrs)]
    physics.set_entries("qpos", addrs, values)
    physics.mark_as_dirty()


class UprightInitializer(WalkerInitializer):
    """Uses the walker-declared upright pose (reference
    initializers/__init__.py:17-31)."""

    def initialize_pose(self, physics, walker, random_state):
        del random_state
        qpos, xpos, xquat = walker.upright_pose
        _reset_walker_joints(physics, walker, qpos)
        try:
            walker.set_pose(physics, position=xpos, quaternion=xquat)
            walker.set_velocity(physics, velocity=np.zeros(3),
                                angular_velocity=np.zeros(3))
        except ValueError:
            pass  # planar-rooted walkers have no free joint


class RandomlySampledInitializer(WalkerInitializer):
    """Randomly selects between many initializers (reference
    initializers/__init__.py:33-44)."""

    def __init__(self, initializers):
        self._initializers = list(initializers)
        self.num_initializers = len(self._initializers)

    def initialize_pose(self, physics, walker, random_state):
        idx = random_state.randint(0, self.num_initializers)
        self._initializers[idx].initialize_pose(physics, walker,
                                                random_state)


class NoOpInitializer(WalkerInitializer):
    """An initializer that does nothing."""

    def initialize_pose(self, physics, walker, random_state):
        pass


class ProneInitializer(WalkerInitializer):
    """Positions the walker lying down (reference
    initializers/__init__.py:52-60)."""

    def initialize_pose(self, physics, walker, random_state):
        del random_state
        _reset_walker_joints(physics, walker)
        try:
            walker.set_pose(physics, position=(0.15, -0.45, 0.1),
                            quaternion=(np.sqrt(0.5), np.sqrt(0.5), 0, 0))
            walker.set_velocity(physics, velocity=np.zeros(3),
                                angular_velocity=np.zeros(3))
        except ValueError:
            pass
