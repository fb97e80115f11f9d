"""Exposes per-step physics profiling as an observation
(reference: dm_control/suite/wrappers/mujoco_profiling.py:25).

The reference reads MuJoCo's step timer (data.timer[0]).  As in the JAX
package, the profiling observation here is the constraint solver's
iteration count of the last step, the quantity that varies from step to
step on the device path.
"""

from __future__ import annotations

import collections

import numpy as np

from dm_control_torch.rl import specs
from dm_control_torch.suite.wrappers.base import DelegatingWrapper


class Wrapper(DelegatingWrapper):
    """Adds a 'profiling' observation: [solver_niter]."""

    def __init__(self, env):
        super().__init__(env)
        obs_spec = collections.OrderedDict(env.observation_spec())
        obs_spec["profiling"] = specs.Array(
            shape=(1,), dtype=np.int32, name="profiling")
        self._observation_spec = obs_spec

    def _add_profiling(self, timestep):
        obs = collections.OrderedDict(timestep.observation)
        obs["profiling"] = np.asarray(
            self._env.physics.data.solver_niter.cpu()).reshape(1).astype(
                np.int32)
        return timestep._replace(observation=obs)

    def step(self, action):
        return self._add_profiling(self._env.step(action))

    def reset(self):
        return self._add_profiling(self._env.reset())

    def observation_spec(self):
        return self._observation_spec
