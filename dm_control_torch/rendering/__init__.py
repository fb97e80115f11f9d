"""Rendering on the physics' device: a ray-cast rasterizer and a Camera
facade (counterpart of ``dm_control_tpu/rendering/``).

Replaces the reference's OpenGL stack (dm_control/_render/ plus
dm_control/mujoco/engine.py:593-983) with an analytic ray caster in
PyTorch tensor work: no GL context, headless, on the card where the
physics is (``Physics.render``, ``suite.wrappers.pixels``,
``composer.observation.MujocoCamera``, the viewer).
"""

from dm_control_torch.rendering.camera import (  # noqa: F401
    Camera, MovableCamera, Pose, camera_pose, render,
)

__all__ = ["Camera", "MovableCamera", "Pose", "camera_pose", "render"]
