"""Interactive viewer: camera + perturbation controllers over the
ray-cast renderer (counterpart of ``dm_control_tpu/viewer/viewer.py``).

Behavioral contract shared with the reference viewer
(dm_control/viewer/viewer.py:88-530): a free camera that pans/rotates/
zooms with the mouse, camera cycling through the model's fixed cameras,
body selection by click, and a manipulation controller that drags the
selected body with a world-space perturbation force.

The camera is the rendering.MovableCamera pose (pure data), selection is
a segmentation ray-cast (no GL picking buffer), and the perturbation is
one ``xfrc_applied`` row written into the env's live state on the
state's own device — the field the physics step consumes.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_torch.physics.model import Data
from dm_control_torch.physics.physics import Physics
from dm_control_torch.viewer import user_input


_PAN_SPEED = 0.003          # meters per pixel per unit distance
_ROTATE_SPEED = 0.4         # degrees per pixel
_ZOOM_FACTOR = 0.05         # distance fraction per scroll unit
_PERTURB_GAIN = 20.0        # Newtons per meter of drag offset


class FreeCameraController:
    """Orbit/pan/zoom state over a rendering.MovableCamera pose
    (reference viewer.py:317-434)."""

    def __init__(self, camera):
        self._camera = camera
        self._pan_horizontal = False
        self._pan_vertical = False
        self._rotate = False

    # mode setters (bound to Exclusive mouse buttons)
    def set_pan_horizontal_mode(self, enable):
        self._pan_horizontal = enable

    def set_pan_vertical_mode(self, enable):
        self._pan_vertical = enable

    def set_rotate_mode(self, enable):
        self._rotate = enable

    def _axes(self):
        """Camera-frame right/up/forward unit vectors in world space."""
        pose = self._camera.get_pose()
        az = np.deg2rad(pose.azimuth)
        el = np.deg2rad(pose.elevation)
        forward = np.array([np.cos(el) * np.cos(az),
                            np.cos(el) * np.sin(az),
                            np.sin(el)])
        right = np.array([-np.sin(az), np.cos(az), 0.0])
        up = np.cross(right, forward)
        return right, up, forward

    def on_move(self, position, translation):
        del position
        dx, dy = float(translation[0]), float(translation[1])
        pose = self._camera.get_pose()
        if self._rotate:
            self._camera.set_pose(
                pose.lookat, pose.distance,
                pose.azimuth - _ROTATE_SPEED * dx,
                float(np.clip(pose.elevation - _ROTATE_SPEED * dy,
                              -89.0, 89.0)))
        elif self._pan_horizontal or self._pan_vertical:
            right, up, _ = self._axes()
            scale = _PAN_SPEED * pose.distance
            if self._pan_horizontal:
                delta = (-dx * right + dy * up) * scale
            else:  # vertical: dy moves along world z
                delta = np.array([0.0, 0.0, dy * scale])
            self._camera.set_pose(pose.lookat + delta, pose.distance,
                                  pose.azimuth, pose.elevation)

    def zoom(self, value):
        pose = self._camera.get_pose()
        distance = float(np.clip(pose.distance * (1.0 - _ZOOM_FACTOR
                                                  * float(value)),
                                 1e-3, 1e6))
        self._camera.set_pose(pose.lookat, distance, pose.azimuth,
                              pose.elevation)

    def look_at(self, point):
        pose = self._camera.get_pose()
        self._camera.set_pose(np.asarray(point, float), pose.distance,
                              pose.azimuth, pose.elevation)


class CameraSelector:
    """Cycles free camera <-> the model's fixed cameras
    (reference viewer.py:263-314)."""

    def __init__(self, n_fixed_cameras: int):
        self._n = n_fixed_cameras
        self._index = -1  # -1 = free camera

    @property
    def camera_id(self) -> int:
        return self._index

    @property
    def is_free(self) -> bool:
        return self._index < 0

    def select_next(self):
        self._index = self._index + 1 if self._index + 1 < self._n else -1

    def select_previous(self):
        self._index = self._index - 1 if self._index >= 0 else self._n - 1


class ManipulationController:
    """Selects a body by click and drags it with a world perturbation
    force (reference viewer.py:437-530).

    ``select(pixel)`` ray-casts the segmentation image at the pixel to
    find the body; while dragging, the controller produces a spring
    force toward the drag target that the runtime writes into the env
    state's ``xfrc_applied``.
    """

    def __init__(self, camera, physics):
        self._camera = camera
        self._physics = physics
        self.selected_body: int | None = None
        self._drag = np.zeros(3)
        self._move_horizontal = False
        self._move_vertical = False

    def select(self, position):
        """Click at pixel (x, y): segmentation lookup -> body id."""
        seg = self._camera.render(segmentation=True)
        x = int(np.clip(position[0], 0, seg.shape[1] - 1))
        y = int(np.clip(position[1], 0, seg.shape[0] - 1))
        geom_id = int(np.asarray(seg)[y, x, 0])
        if geom_id < 0:
            self.selected_body = None
        else:
            self.selected_body = int(
                np.asarray(self._physics.model.geom_bodyid)[geom_id])
        self._drag[:] = 0.0
        return self.selected_body

    def set_move_horizontal_mode(self, enable):
        self._move_horizontal = enable
        if not enable:
            self._drag[:] = 0.0

    def set_move_vertical_mode(self, enable):
        self._move_vertical = enable
        if not enable:
            self._drag[:] = 0.0

    def on_move(self, position, translation):
        del position
        if self.selected_body is None:
            return
        dx, dy = float(translation[0]), float(translation[1])
        scale = 0.01
        if self._move_horizontal:
            self._drag += np.array([dx, -dy, 0.0]) * scale
        elif self._move_vertical:
            self._drag += np.array([0.0, 0.0, -dy]) * scale

    @property
    def perturbation_force(self):
        """(body_id, force6) or None — consumed by the runtime each step."""
        if self.selected_body is None or not np.any(self._drag):
            return None
        force = np.zeros(6)
        force[:3] = _PERTURB_GAIN * self._drag
        return self.selected_body, force


def _state_owner(env):
    """What holds the env's live Data in ``_data``: the env itself (the
    suite's ``rl.control.Environment``) or its ``Physics``
    (``composer.Environment``), looked up through any wrappers; None
    before the first reset or for an env without one."""
    while env is not None:
        attrs = vars(env)
        if isinstance(attrs.get("_data"), Data):
            return env
        if isinstance(attrs.get("_physics"), Physics):
            return attrs["_physics"]
        env = attrs.get("_env")
    return None


def apply_perturbation(env, body_id: int, force6) -> bool:
    """Writes an xfrc_applied row into a (suite/composer) env's live state,
    on the state's device; every other body's row is zero.

    Returns False when the env exposes no mutable state (the viewer then
    shows the selection without forces)."""
    owner = _state_owner(env)
    if owner is None:
        return False
    data = owner._data
    xfrc = torch.zeros_like(data.xfrc_applied)
    xfrc[:, body_id] = torch.as_tensor(np.asarray(force6, np.float64),
                                       dtype=xfrc.dtype, device=xfrc.device)
    owner._data = data.replace(xfrc_applied=xfrc)
    return True


class Viewer:
    """Wires the InputMap to the controllers (reference viewer.py:88-230
    key bindings)."""

    def __init__(self, camera, physics, n_fixed_cameras=0):
        self.input_map = user_input.InputMap()
        self.free_camera = FreeCameraController(camera)
        self.camera_select = CameraSelector(n_fixed_cameras)
        self.manipulator = ManipulationController(camera, physics)
        self._bind()

    def _bind(self):
        im = self.input_map
        im.bind(self.free_camera.set_rotate_mode,
                user_input.Exclusive(user_input.MOUSE_LEFT))
        im.bind(self.free_camera.set_pan_horizontal_mode,
                user_input.Exclusive(user_input.MOUSE_RIGHT))
        im.bind(self.free_camera.set_pan_vertical_mode,
                user_input.Exclusive((user_input.MOD_SHIFT,
                                      user_input.MOUSE_RIGHT)))
        im.bind(self.manipulator.set_move_horizontal_mode,
                user_input.Exclusive((user_input.MOD_CONTROL,
                                      user_input.MOUSE_LEFT)))
        im.bind(self.manipulator.set_move_vertical_mode,
                user_input.Exclusive((user_input.MOD_CONTROL,
                                      user_input.MOUSE_RIGHT)))
        im.bind(self.camera_select.select_next, "]")
        im.bind(self.camera_select.select_previous, "[")
        im.bind_plane(self.free_camera.on_move)
        im.bind_plane(self.manipulator.on_move)
        im.bind_z_axis(self.free_camera.zoom)

    def select_at(self, position):
        return self.manipulator.select(position)
