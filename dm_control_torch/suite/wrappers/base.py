"""Shared delegating base for suite wrappers.

Each wrapper overrides only the methods it changes; everything else
forwards to the wrapped environment.
"""

from __future__ import annotations

from dm_control_torch.rl import environment


class DelegatingWrapper(environment.Environment):
    """Forwards the whole dm_env interface to ``self._env``."""

    def __init__(self, env):
        self._env = env

    def reset(self):
        return self._env.reset()

    def step(self, action):
        return self._env.step(action)

    def action_spec(self):
        return self._env.action_spec()

    def observation_spec(self):
        return self._env.observation_spec()

    def reward_spec(self):
        return self._env.reward_spec()

    def discount_spec(self):
        return self._env.discount_spec()

    def close(self):
        return self._env.close()

    def __getattr__(self, name):
        return getattr(self._env, name)
