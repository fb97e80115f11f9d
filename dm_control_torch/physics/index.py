"""Named indexing: ``physics.named.data.qpos['hinge']`` FieldIndexer views.

Counterpart of ``dm_control_tpu/physics/index.py`` (reference:
dm_control/mujoco/index.py:264-661): per-axis name -> index maps,
including ragged axes (rows of qpos, of dofs and of sensordata, through
``jnt_qposadr``, ``jnt_dofadr`` and ``sensor_adr``) and named columns
('x', 'y', 'z' / 'qw', 'qx', 'qy', 'qz' / the rotation matrix's
'xx' .. 'zz' / 'r', 'g', 'b', 'a').  Reads return numpy copies of the
first (the only) environment's values; a write replaces the field on the
owning ``Physics`` with an updated copy and marks it dirty (lazy
forward).
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_torch.physics.model import JointType

_COLUMN_NAMES = {
    "xyz": ("x", "y", "z"),
    "quat": ("qw", "qx", "qy", "qz"),
    "mat": ("xx", "xy", "xz", "yx", "yy", "yz", "zx", "zy", "zz"),
    "rgba": ("r", "g", "b", "a"),
}

#: joint type -> (qpos width, dof width)
JOINT_WIDTHS = {JointType.FREE: (7, 6), JointType.BALL: (4, 3),
                JointType.SLIDE: (1, 1), JointType.HINGE: (1, 1)}

# (namespace, ragged, columns) per field; namespace keys into m.names
_DATA_FIELDS = {
    "qpos": ("joint", "qpos", None),
    "qvel": ("joint", "dof", None),
    "qacc": ("joint", "dof", None),
    "qfrc_applied": ("joint", "dof", None),
    "qfrc_actuator": ("joint", "dof", None),
    "qfrc_bias": ("joint", "dof", None),
    "qfrc_passive": ("joint", "dof", None),
    "qfrc_constraint": ("joint", "dof", None),
    "xpos": ("body", None, "xyz"),
    "xquat": ("body", None, "quat"),
    "xmat": ("body", None, "mat"),
    "xipos": ("body", None, "xyz"),
    "ximat": ("body", None, "mat"),
    "subtree_com": ("body", None, "xyz"),
    "cvel": ("body", None, None),
    "xfrc_applied": ("body", None, None),
    "geom_xpos": ("geom", None, "xyz"),
    "geom_xmat": ("geom", None, "mat"),
    "site_xpos": ("site", None, "xyz"),
    "site_xmat": ("site", None, "mat"),
    "jnt_xanchor": ("joint", None, "xyz"),
    "jnt_xaxis": ("joint", None, "xyz"),
    "ctrl": ("actuator", None, None),
    "act": ("actuator", None, None),
    "actuator_force": ("actuator", None, None),
    "actuator_length": ("actuator", None, None),
    "actuator_velocity": ("actuator", None, None),
    "sensordata": ("sensor", "sensor", None),
    "ten_length": ("tendon", None, None),
    "ten_velocity": ("tendon", None, None),
}

_MODEL_FIELDS = {
    "body_pos": ("body", None, "xyz"),
    "body_ipos": ("body", None, "xyz"),
    "body_quat": ("body", None, "quat"),
    "body_mass": ("body", None, None),
    "body_inertia": ("body", None, "xyz"),
    "jnt_range": ("joint", None, None),
    "jnt_stiffness": ("joint", None, None),
    "jnt_pos": ("joint", None, "xyz"),
    "jnt_axis": ("joint", None, "xyz"),
    "dof_damping": ("joint", "dof", None),
    "dof_armature": ("joint", "dof", None),
    "geom_pos": ("geom", None, "xyz"),
    "geom_quat": ("geom", None, "quat"),
    "geom_size": ("geom", None, "xyz"),
    "geom_rgba": ("geom", None, "rgba"),
    "geom_friction": ("geom", None, None),
    "site_pos": ("site", None, "xyz"),
    "site_quat": ("site", None, "quat"),
    "site_size": ("site", None, "xyz"),
    "actuator_ctrlrange": ("actuator", None, None),
    "actuator_gear": ("actuator", None, None),
    "cam_pos": ("camera", None, "xyz"),
    "cam_quat": ("camera", None, "quat"),
}


class FieldIndexer:
    """Name-addressable view of one array field
    (reference index.py:436): ``idx['torso']``, ``idx['torso', 'z']``,
    ``idx[['a', 'b']]``, and the same forms for assignment."""

    __slots__ = ("_physics", "_source", "_field", "_namespace", "_ragged",
                 "_columns")

    def __init__(self, physics, source, field, namespace, ragged, columns):
        self._physics = physics
        self._source = source  # "data" | "model"
        self._field = field
        self._namespace = namespace
        self._ragged = ragged
        self._columns = _COLUMN_NAMES.get(columns) if columns else None

    def _array(self) -> torch.Tensor:
        """The field of the one environment (data) or of the model."""
        holder = (self._physics.data if self._source == "data"
                  else self._physics.model)
        return getattr(holder, self._field)

    def _names(self):
        return getattr(self._physics.model.names, self._namespace)

    def _row_index(self, name):
        """(first row, width) of ``name``; width 0 for a field with one row
        per name."""
        m = self._physics.model
        i = self._names()[name]
        if self._ragged == "qpos":
            return m.jnt_qposadr[i], JOINT_WIDTHS[m.jnt_type[i]][0]
        if self._ragged == "dof":
            return m.jnt_dofadr[i], JOINT_WIDTHS[m.jnt_type[i]][1]
        if self._ragged == "sensor":
            return m.sensor_adr[i], m.sensor_dim[i]
        return i, 0

    def _col_index(self, col):
        if isinstance(col, str):
            if not self._columns:
                raise KeyError(f"{self._field} has no named columns")
            return self._columns.index(col)
        return col

    def _split_key(self, key):
        if isinstance(key, tuple) and len(key) == 2:
            rows, cols = key
        else:
            rows, cols = key, None
        single = isinstance(rows, str)
        row_list = [rows] if single else list(rows)
        if cols is not None:
            if isinstance(cols, (str, int)):
                cols = self._col_index(cols)
            else:
                cols = [self._col_index(c) for c in cols]
        return row_list, cols, single

    def __getitem__(self, key):
        rows, cols, single = self._split_key(key)
        arr = self._array().detach().cpu().numpy()
        out = []
        for name in rows:
            a, w = self._row_index(name)
            row = arr[a:a + w] if w else arr[a]
            if w == 1:
                row = row[0]
            if cols is not None:
                row = row.reshape(-1)[cols] if row.ndim else row
            out.append(row)
        if single:
            return out[0]
        return (np.stack(out) if all(np.shape(o) == np.shape(out[0])
                                     for o in out) else out)

    def __setitem__(self, key, value):
        rows, cols, single = self._split_key(key)
        physics = self._physics
        if self._source == "data":
            full = getattr(physics._data, self._field).clone()
            arr = full[0]  # a view: writes reach ``full``
        else:
            full = arr = getattr(physics.model, self._field).clone()
        vals = [value] if single else list(value)
        for name, v in zip(rows, vals):
            a, w = self._row_index(name)
            v = torch.as_tensor(v, dtype=arr.dtype, device=arr.device)
            if cols is not None:
                if w:
                    raise KeyError("column index on a ragged field")
                row = arr[a].reshape(-1).clone()
                row[cols] = v
                arr[a] = row.reshape(arr.shape[1:])
            elif w:
                arr[a:a + w] = v.reshape(w)
            else:
                arr[a] = v
        if self._source == "data":
            physics._data = physics._data.replace(**{self._field: full})
        else:
            physics._model = physics.model.replace(**{self._field: full})
        physics.mark_as_dirty()

    @property
    def axes(self):
        """(row_names, column_names) of this view."""
        return (tuple(self._names()), self._columns)

    def __repr__(self):
        return (f"FieldIndexer({self._source}.{self._field}, "
                f"rows={self._namespace})")


class _NamedView:
    __slots__ = ("_physics", "_source", "_table")

    def __init__(self, physics, source, table):
        self._physics = physics
        self._source = source
        self._table = table

    def __getattr__(self, field):
        if field not in self._table:
            raise AttributeError(
                f"no named view for {self._source}.{field}")
        ns, ragged, cols = self._table[field]
        return FieldIndexer(self._physics, self._source, field, ns,
                            ragged, cols)

    def __dir__(self):
        return list(self._table)


class Named:
    """``physics.named`` root: .data and .model FieldIndexer factories
    (reference index.py struct_indexer, :584)."""

    __slots__ = ("data", "model")

    def __init__(self, physics):
        self.data = _NamedView(physics, "data", _DATA_FIELDS)
        self.model = _NamedView(physics, "model", _MODEL_FIELDS)
