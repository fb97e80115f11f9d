"""Recorded scenes that the renderer is held to, and the frame gate.

A render recording (``tests/data/torch_render_<name>.npz``, written by
``tools/export_torch_assets.py render_goldens``) is one scene of
``SCENES`` after its reset and ``steps`` control steps on the CPU in
float32: environment 0's body and geom poses (``state_<field>`` for
``STATE_FIELDS``), the model's fields the renderer reads
(``model_<field>`` for ``MODEL_FIELDS``), the free camera's pose where
the scene is framed by one (``pose``: lookat x, y, z, distance, azimuth,
elevation), and the JAX package's frames of that state (``rgb``,
``depth``, ``seg``: the segmentation's geom ids).  ``scene_physics``
builds the scene anew on any device and gives it the recorded state;
``render_frames`` renders it there; ``frame_figures`` and ``GATE`` hold
one set of frames to another.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

#: environment 0's Data fields a frame reads
STATE_FIELDS = ("xpos", "xmat", "subtree_com", "geom_xpos", "geom_xmat")
#: the Model fields a frame reads (``stat.`` for the nested ones)
MODEL_FIELDS = ("geom_size", "geom_rbound", "geom_rgba", "cam_pos",
                "cam_quat", "cam_fovy", "cam_pos0", "cam_poscom0",
                "cam_mat0", "hfield_size", "mesh_kdop", "stat.center",
                "stat.extent")
#: a frame against another of the same state: the share of pixels whose
#: segmentation is equal (at least ``seg``), and where it is equal the
#: plane depth within ``depth`` x max(1, depth) and every channel within
#: ``rgb`` levels
GATE = {"seg": 0.999, "depth": 1e-5, "rgb": 1}
KINDS = ("rgb", "depth", "seg")


@dataclasses.dataclass(frozen=True)
class Scene:
    """A scene: ``build(device, dtype, seed)`` -> (environment, the free
    camera that frames it or None), the seed, the control steps after the
    reset, the model camera (an id or name; None for the free camera) and
    the frame's size."""

    build: Callable
    seed: int
    steps: int
    camera: Optional[Union[int, str]]
    height: int
    width: int


def _suite(domain, task):
    def build(device, dtype, seed):
        from dm_control_torch import suite

        return suite.load(domain, task, task_kwargs={"random": seed},
                          device=device, dtype=dtype), None
    return build


def stack_3_bricks_vision(device, dtype, seed):
    """``stack_3_bricks_vision`` with the reference's ``front_close``
    camera added to its arena (the JAX package's task adds no camera)."""
    from dm_control_torch import composer
    from dm_control_torch.manipulation.shared import (
        cameras, observations, registry,
    )

    task = registry.get("stack_3_bricks_vision")()
    cameras.add_camera_observables(task.root_entity, observations.VISION,
                                   cameras.FRONT_CLOSE)
    env = composer.Environment(task, time_limit=task.time_limit,
                               device=device, dtype=dtype)
    env.random_state.seed(seed)
    return env, None


def soccer_tracked(device, dtype, seed, team_size=2, width=1920,
                   height=1080):
    """A ``soccer.Task`` of ``team_size`` a side as ``soccer.load`` builds
    it (BoxHead players, a pitch drawn and compiled every episode) with a
    ``MultiplayerTrackingCamera`` of ``width`` x ``height``."""
    from dm_control_torch import composer
    from dm_control_torch.locomotion import soccer

    camera = soccer.MultiplayerTrackingCamera(
        min_distance=8.0, distance_factor=1.0, smoothing_update_speed=0.5,
        width=width, height=height)
    task = soccer.Task(soccer.task.standard_players(team_size),
                       soccer.RandomizedPitch(min_size=(32, 24),
                                              max_size=(48, 36)),
                       tracking_cameras=(camera,))
    env = composer.Environment(task, time_limit=45.0, random_state=seed,
                               recompile_mjcf_every_episode=True,
                               device=device, dtype=dtype)
    return env, camera


SCENES: Dict[str, Scene] = {
    "humanoid_cmu": Scene(_suite("humanoid_CMU", "run"), seed=3, steps=2,
                          camera=0, height=240, width=320),
    # camera "y": the height field's box beside the floor and the walker
    "quadruped_escape": Scene(_suite("quadruped", "escape"), seed=3,
                              steps=0, camera="y", height=240, width=320),
    "stack_3_bricks": Scene(stack_3_bricks_vision, seed=3, steps=1,
                            camera="front_close", height=84, width=84),
    "soccer_2v2": Scene(soccer_tracked, seed=3, steps=3, camera=None,
                        height=240, width=320),
}


def _model_field(m, field):
    obj = m
    for part in field.split("."):
        obj = getattr(obj, part)
    return obj


def record(name, device="cpu", dtype=torch.float32):
    """Runs scene ``name`` (its reset, then its steps with actions drawn
    from numpy seed ``seed``); returns its physics and the recording's
    ``state_*`` and ``model_*`` keys, with ``pose`` where the free camera
    frames the scene."""
    scene = SCENES[name]
    env, camera = scene.build(device, dtype, scene.seed)
    env.reset()
    spec = env.action_spec()
    rng = np.random.RandomState(scene.seed)
    for _ in range(scene.steps):
        env.step(rng.uniform(spec.minimum, spec.maximum))
    physics = env.physics
    out = {f"state_{f}": getattr(physics.data, f).cpu().numpy()
           for f in STATE_FIELDS}
    for f in MODEL_FIELDS:
        v = _model_field(physics.model, f)
        if v is not None:
            out[f"model_{f}"] = v.cpu().numpy()
    if camera is not None:
        p = camera.camera.get_pose()
        out["pose"] = np.concatenate([p.lookat, [p.distance, p.azimuth,
                                                 p.elevation]])
    return physics, out


def scene_physics(name, gold, device, dtype=torch.float32):
    """Scene ``name`` built on ``device`` (its model from its own tree, the
    reset's draws from its seed) with the recorded state of ``gold`` set
    on it; a ``Physics``.  Raises ``ValueError`` where the model's fields
    a frame reads differ from the recording's."""
    from dm_control_torch.physics.physics import Physics

    scene = SCENES[name]
    env, _ = scene.build(device, dtype, scene.seed)
    env.reset()
    physics = env.physics
    if not isinstance(physics, Physics):  # the suite's read-only view
        physics = Physics(physics.model)
    for f in MODEL_FIELDS:
        v = _model_field(physics.model, f)
        if v is not None and not np.array_equal(v.cpu().numpy(),
                                                gold[f"model_{f}"]):
            raise ValueError(f"render golden {name}: the model's {f} "
                             f"differs from the recording's")
    physics.set_data(**{f: gold[f"state_{f}"] for f in STATE_FIELDS})
    return physics


def render_frames(physics, name, pose=None, kinds=KINDS):
    """Scene ``name``'s frames of ``physics`` as numpy: ``rgb``,
    ``depth`` and ``seg`` (the segmentation's geom ids), from its model
    camera or from the free camera at ``pose`` (lookat x, y, z, distance,
    azimuth, elevation)."""
    from dm_control_torch.rendering.camera import Camera, MovableCamera

    scene = SCENES[name]
    if scene.camera is None:
        cam = MovableCamera(physics, scene.height, scene.width)
        cam.set_pose(pose[:3], *pose[3:])
    else:
        cam = Camera(physics, scene.height, scene.width, scene.camera)
    return camera_frames(cam, kinds)


def camera_frames(camera, kinds=KINDS):
    """A ``Camera``'s frames as numpy: ``rgb``, ``depth`` and ``seg`` (the
    segmentation's geom ids)."""
    out = {}
    for kind in kinds:
        frame = camera.render(depth=kind == "depth",
                              segmentation=kind == "seg")
        out[kind] = frame[..., 0] if kind == "seg" else frame
    return out


def frame_figures(ours, ref):
    """The gate's figures of frames ``ours`` against ``ref`` (dicts of
    ``rgb``, ``depth`` and ``seg`` ids): the share of equal segmentation,
    and where it is equal the largest plane-depth difference over
    max(1, depth) and the largest channel difference in levels."""
    same = np.asarray(ours["seg"]) == np.asarray(ref["seg"])
    depth = np.abs(ours["depth"].astype(np.float64) - ref["depth"]) / \
        np.maximum(1.0, np.abs(ref["depth"].astype(np.float64)))
    rgb = np.abs(ours["rgb"].astype(np.int64)
                 - ref["rgb"].astype(np.int64)).max(axis=-1)
    return {"seg": float(same.mean()),
            "depth": float(depth[same].max(initial=0.0)),
            "rgb": int(rgb[same].max(initial=0))}


def within_gate(figures) -> bool:
    return (figures["seg"] >= GATE["seg"]
            and figures["depth"] <= GATE["depth"]
            and figures["rgb"] <= GATE["rgb"])
