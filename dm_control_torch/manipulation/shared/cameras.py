"""Camera specs for manipulation tasks (counterpart of
``dm_control_tpu/manipulation/shared/cameras.py``; reference:
dm_control/manipulation/shared/cameras.py:24-40)."""

from __future__ import annotations

import collections

CameraSpec = collections.namedtuple("CameraSpec",
                                    ["name", "pos", "xyaxes"])

FRONT_CLOSE = CameraSpec(
    name="front_close",
    pos=(0.0, -0.6, 0.75),
    xyaxes=(1.0, 0.0, 0.0, 0.0, 0.7, 0.75))

FRONT_FAR = CameraSpec(
    name="front_far",
    pos=(0.0, -0.9, 1.1),
    xyaxes=(1.0, 0.0, 0.0, 0.0, 0.7, 0.75))


def add_camera_observables(arena, obs_settings, *specs):
    """Adds cameras to the arena worldbody; returns observable names.

    Only the ``<camera>`` elements, as in the JAX package: a
    ``composer.observation.MujocoCamera`` of a returned name renders it.
    """
    wb = arena.mjcf_model.first("worldbody")
    names = []
    for spec in specs:
        wb.add("camera", name=spec.name,
               pos=" ".join(map(str, spec.pos)),
               xyaxes=" ".join(map(str, spec.xyaxes)))
        names.append(spec.name)
    return names
