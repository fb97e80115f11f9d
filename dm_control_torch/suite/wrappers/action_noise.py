"""Gaussian exploration noise on the action channel.

Behavioral parity with dm_control/suite/wrappers/action_noise.py:
zero-mean Gaussian noise with per-dimension std ``scale * range`` is
added to every action and the sum is clipped to the spec bounds.  The
noise is drawn from the environment's episode RandomState, so a noisy
episode is the JAX package's under the same seed.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.suite.wrappers.base import DelegatingWrapper


class Wrapper(DelegatingWrapper):
    """Perturbs each action with clipped Gaussian noise."""

    def __init__(self, env, scale=0.01):
        super().__init__(env)
        spec = env.action_spec()
        lo = np.asarray(spec.minimum)
        hi = np.asarray(spec.maximum)
        if not (np.isfinite(lo).all() and np.isfinite(hi).all()):
            raise ValueError(
                "action_noise.Wrapper needs finite action bounds to scale "
                f"the noise; got spec {spec}")
        self._lo, self._hi = lo, hi
        self._std = scale * (hi - lo)

    def step(self, action):
        draw = self._env.random_state.normal(size=np.shape(self._std))
        perturbed = np.clip(action + draw * self._std, self._lo, self._hi)
        return self._env.step(perturbed)
