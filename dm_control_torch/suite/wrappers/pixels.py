"""Pixel-observation wrapper (counterpart of
``dm_control_tpu/suite/wrappers/pixels.py``; reference:
dm_control/suite/wrappers/pixels.py:25).

Renders through the port's ray-cast rasterizer
(``dm_control_torch/rendering/``) on the physics' device.  Another
backend can be swapped in, explicitly, with ``set_render_backend``.
"""

from __future__ import annotations

import collections

import numpy as np

from dm_control_torch.rl import environment, specs

STATE_KEY = "state"

_RENDER_BACKEND = None


def set_render_backend(fn):
    """Registers ``fn(physics, height, width, camera_id) -> uint8 array``
    (None restores the ray-cast renderer)."""
    global _RENDER_BACKEND
    _RENDER_BACKEND = fn


class Wrapper(environment.Environment):
    """Replaces (or augments) observations with rendered pixels."""

    def __init__(self, env, pixels_only=True, render_kwargs=None,
                 observation_key="pixels"):
        if render_kwargs is None:
            render_kwargs = {}
        self._height = render_kwargs.get("height", 240)
        self._width = render_kwargs.get("width", 320)
        self._camera_id = render_kwargs.get("camera_id", 0)
        self._env = env
        self._pixels_only = pixels_only
        self._observation_key = observation_key

        if pixels_only:
            self._observation_spec = collections.OrderedDict()
        else:
            self._observation_spec = collections.OrderedDict(
                env.observation_spec())
        self._observation_spec[observation_key] = specs.Array(
            shape=(self._height, self._width, 3), dtype=np.uint8,
            name=observation_key)

    def _render(self):
        if _RENDER_BACKEND is not None:
            return _RENDER_BACKEND(self._env.physics, self._height,
                                   self._width, self._camera_id)
        return self._env.physics.render(
            height=self._height, width=self._width,
            camera_id=self._camera_id)

    def _add_pixels(self, timestep):
        if self._pixels_only:
            obs = collections.OrderedDict()
        else:
            obs = collections.OrderedDict(timestep.observation)
        obs[self._observation_key] = self._render()
        return timestep._replace(observation=obs)

    def step(self, action):
        return self._add_pixels(self._env.step(action))

    def reset(self):
        return self._add_pixels(self._env.reset())

    def observation_spec(self):
        return self._observation_spec

    def action_spec(self):
        return self._env.action_spec()

    def __getattr__(self, name):
        return getattr(self._env, name)
