"""Multiplayer tracking camera (counterpart of
``dm_control_tpu/locomotion/soccer/camera.py``; reference:
dm_control/locomotion/soccer/camera.py:15-119).

Targets the centroid of the tracked entities at a distance scaled by
their spread, exponentially smoothed each control step; frames render
through the ray-cast ``MovableCamera`` on the physics' device."""

from __future__ import annotations

import numpy as np

from dm_control_torch.rendering.camera import MovableCamera, Pose


class MultiplayerTrackingCamera:
    """A camera that smoothly tracks the ball and all players."""

    def __init__(self, min_distance, distance_factor,
                 smoothing_update_speed, azimuth=90, elevation=-45,
                 width=1920, height=1080):
        self._min_distance = min_distance
        self._distance_factor = distance_factor
        if not 0 <= smoothing_update_speed <= 1:
            raise ValueError("Filter speed must be in range [0, 1].")
        self._smoothing_update_speed = smoothing_update_speed
        self._azimuth = azimuth
        self._elevation = elevation
        self._width = width
        self._height = height
        self._camera = None

    @property
    def camera(self):
        return self._camera

    def render(self):
        """Render the current frame."""
        if self._camera is None:
            raise ValueError(
                "Camera has not been initialized yet. render can only be"
                " called after physics has been compiled.")
        return self._camera.render()

    def after_compile(self, physics):
        self._camera = MovableCamera(physics, height=self._height,
                                     width=self._width)

    def _get_target_camera_pose(self, entity_positions):
        stacked = np.stack(entity_positions)
        centroid = np.mean(stacked, axis=0)
        radii = np.linalg.norm(stacked - centroid, axis=1)
        distance = self._min_distance + self._distance_factor * np.max(radii)
        return Pose(lookat=centroid, distance=distance,
                    azimuth=self._azimuth, elevation=self._elevation)

    def initialize_episode(self, entity_positions):
        """Begin the episode with the camera at its target pose."""
        self._camera.set_pose(*self._get_target_camera_pose(
            entity_positions))

    def after_step(self, entity_positions):
        """Exponentially pull the camera toward its target pose."""
        target = self._get_target_camera_pose(entity_positions)
        cur = self._camera.get_pose()
        s = self._smoothing_update_speed
        filtered = [np.asarray(t) * s + np.asarray(c) * (1 - s)
                    for t, c in zip(target, cur)]
        self._camera.set_pose(*filtered)
