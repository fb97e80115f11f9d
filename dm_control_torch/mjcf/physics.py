"""PyMJCF binding layer: ``physics.bind(elements)`` attribute views.

The port's copy of ``dm_control_tpu/mjcf/physics.py``, on the port's
``Physics`` (one environment, B = 1): reads return numpy copies, writes
clone the field, set the rows and put the new tensor back.

Reference: dm_control/mjcf/physics.py:270-560 — ``Binding`` objects give
read/write attribute access into mjModel/mjData for MJCF elements, with a
dirty/lazy-forward protocol: writing state marks the physics dirty;
reading a derived quantity (FK frames, sensors) first recomputes forward
kinematics.

Model and Data are replaced, not written in place: a write goes through
``replace`` on the owning ``Physics``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dm_control_torch.physics.model import JointType

# tag → names namespace
_TAG_NAMESPACE = {
    "body": "body",
    "joint": "joint",
    "freejoint": "joint",
    "geom": "geom",
    "site": "site",
    "camera": "camera",
    "tendon": "tendon",
    "fixed": "tendon",
    "spatial": "tendon",
    "general": "actuator",
    "motor": "actuator",
    "position": "actuator",
    "velocity": "actuator",
    "cylinder": "actuator",
    "muscle": "actuator",
    "adhesion": "actuator",
    "touch": "sensor",
    "accelerometer": "sensor",
    "velocimeter": "sensor",
    "gyro": "sensor",
    "force": "sensor",
    "torque": "sensor",
    "rangefinder": "sensor",
    "subtreelinvel": "sensor",
    "subtreecom": "sensor",
    "subtreeangmom": "sensor",
    "jointpos": "sensor",
    "jointvel": "sensor",
    "framepos": "sensor",
    "framequat": "sensor",
}

# namespace → attribute → ("model"|"data", field, addressing)
# addressing: None = direct row index; "qpos"/"dof" = ragged joint
# address; "sensor" = (adr, dim) slice
_ATTRIBUTES = {
    "body": {
        "pos": ("model", "body_pos", None),
        "quat": ("model", "body_quat", None),
        "mass": ("model", "body_mass", None),
        "ipos": ("model", "body_ipos", None),
        "inertia": ("model", "body_inertia", None),
        "xpos": ("data", "xpos", None),
        "xquat": ("data", "xquat", None),
        "xmat": ("data", "xmat", None),
        "xipos": ("data", "xipos", None),
        "subtree_com": ("data", "subtree_com", None),
        "xfrc_applied": ("data", "xfrc_applied", None),
        "cvel": ("data", "cvel", None),
    },
    "joint": {
        "range": ("model", "jnt_range", None),
        "stiffness": ("model", "jnt_stiffness", None),
        "damping": ("model", "dof_damping", "dof"),
        "armature": ("model", "dof_armature", "dof"),
        "qpos": ("data", "qpos", "qpos"),
        "qvel": ("data", "qvel", "dof"),
        "qacc": ("data", "qacc", "dof"),
        "qfrc_applied": ("data", "qfrc_applied", "dof"),
        "xanchor": ("data", "jnt_xanchor", None),
        "xaxis": ("data", "jnt_xaxis", None),
    },
    "geom": {
        "pos": ("model", "geom_pos", None),
        "quat": ("model", "geom_quat", None),
        "size": ("model", "geom_size", None),
        "rgba": ("model", "geom_rgba", None),
        "friction": ("model", "geom_friction", None),
        "xpos": ("data", "geom_xpos", None),
        "xmat": ("data", "geom_xmat", None),
    },
    "site": {
        "pos": ("model", "site_pos", None),
        "quat": ("model", "site_quat", None),
        "size": ("model", "site_size", None),
        "xpos": ("data", "site_xpos", None),
        "xmat": ("data", "site_xmat", None),
    },
    "actuator": {
        "ctrlrange": ("model", "actuator_ctrlrange", None),
        "gear": ("model", "actuator_gear", None),
        "ctrl": ("data", "ctrl", None),
        "force": ("data", "actuator_force", None),
        "length": ("data", "actuator_length", None),
        "velocity": ("data", "actuator_velocity", None),
    },
    "sensor": {
        "sensordata": ("data", "sensordata", "sensor"),
    },
    "tendon": {
        "length": ("data", "ten_length", None),
        "velocity": ("data", "ten_velocity", None),
    },
    "camera": {
        "pos": ("model", "cam_pos", None),
        "quat": ("model", "cam_quat", None),
        "fovy": ("model", "cam_fovy", None),
    },
}

# writing one of these invalidates derived quantities (mirrors the
# reference's mark_as_dirty triggers, mjcf/physics.py:536-545)
_STATE_FIELDS = {"qpos", "qvel", "qacc", "act", "ctrl", "qfrc_applied",
                 "xfrc_applied"}


def _resolve_name(element) -> str:
    if isinstance(element, str):
        return element
    name = element.get("name")
    if name is None:
        raise ValueError(
            f"Cannot bind unnamed <{element.tag}> element; give it a name.")
    return name


class Binding:
    """Read/write attribute views for one or more same-kind elements
    (reference mjcf/physics.py:270 ``Binding``)."""

    __slots__ = ("_physics", "_namespace", "_ids", "_names", "_single")

    def __init__(self, physics, namespace: str, names: Sequence[str],
                 single: bool):
        object.__setattr__(self, "_physics", physics)
        object.__setattr__(self, "_namespace", namespace)
        object.__setattr__(self, "_names", tuple(names))
        m = physics.model
        ns = getattr(m.names, namespace)
        object.__setattr__(self, "_ids", tuple(ns[n] for n in names))
        object.__setattr__(self, "_single", single)

    @property
    def element_id(self):
        return self._ids[0] if self._single else np.asarray(self._ids)

    def _spec(self, attr):
        table = _ATTRIBUTES[self._namespace]
        if attr not in table:
            raise AttributeError(
                f"{self._namespace} binding has no attribute {attr!r}")
        return table[attr]

    def _addresses(self, addressing):
        m = self._physics.model
        out = []
        for i in self._ids:
            if addressing == "qpos":
                a = int(m.jnt_qposadr[i])
                w = JointType(m.jnt_type[i]).qpos_width
            elif addressing == "dof":
                a = int(m.jnt_dofadr[i])
                w = JointType(m.jnt_type[i]).dof_width
            elif addressing == "sensor":
                a, w = int(m.sensor_adr[i]), int(m.sensor_dim[i])
            else:
                raise KeyError(addressing)
            out.append((a, w))
        return out

    def __getattr__(self, attr):
        source, field, addressing = self._spec(attr)
        physics = self._physics
        if source == "data" and attr not in ("ctrl", "qpos", "qvel", "act",
                                             "qfrc_applied", "xfrc_applied"):
            physics._ensure_clean()  # derived read → lazy forward
        arr = getattr(physics.data if source == "data" else physics.model,
                      field).detach().cpu().numpy()
        if addressing is None:
            rows = [arr[i] for i in self._ids]
        else:
            rows = [arr[a] if w == 1 else arr[a:a + w]
                    for a, w in self._addresses(addressing)]
        if self._single:
            return np.array(rows[0])
        if all(np.shape(r) == np.shape(rows[0]) for r in rows):
            return np.stack([np.atleast_1d(r) for r in rows])
        return [np.array(r) for r in rows]

    def __setattr__(self, attr, value):
        source, field, addressing = self._spec(attr)
        physics = self._physics
        if source == "data":
            arr = getattr(physics._data, field).clone()
            rows = arr[0]  # the one environment's row, a view
        else:
            arr = getattr(physics.model, field).clone()
            rows = arr
        value = np.asarray(value)
        vals = ([value] if self._single
                else [value[i] for i in range(len(self._ids))])

        def tensor(v):
            return torch.as_tensor(np.asarray(v), dtype=arr.dtype,
                                   device=arr.device)

        if addressing is None:
            for i, v in zip(self._ids, vals):
                rows[i] = tensor(v)
        else:
            for (a, w), v in zip(self._addresses(addressing), vals):
                if w == 1:
                    rows[a] = tensor(v).reshape(())
                else:
                    rows[a:a + w] = tensor(v)
        if source == "data":
            physics._data = physics._data.replace(**{field: arr})
        else:
            physics._model = physics.model.replace(**{field: arr})
        physics.mark_as_dirty()


def bind(physics, elements) -> Optional[Binding]:
    """Returns a Binding for the element(s) (reference physics.bind,
    mjcf/physics.py:560)."""
    single = not isinstance(elements, (list, tuple))
    elems = [elements] if single else list(elements)
    if not elems:
        return None
    tags = set()
    names = []
    for e in elems:
        tag = "body" if isinstance(e, str) else e.tag
        if tag not in _TAG_NAMESPACE:
            raise ValueError(f"Cannot bind <{tag}> elements")
        tags.add(_TAG_NAMESPACE[tag])
        names.append(_resolve_name(e))
    if len(tags) > 1:
        raise ValueError(f"Cannot bind mixed element kinds: {tags}")
    return Binding(physics, tags.pop(), names, single)
