"""Suite task base with named access to batched model data.
Counterpart of ``dm_control_tpu/suite/base.py``.

Every domain module of the suite has the same small interface, which
``suite.load`` and ``suite.load_batch`` read: ``TASKS`` (a
``utils.containers.TaggedTasks``: task name -> a constructor, called
with the task's keyword arguments, of ``(asset name, task object)`` or
``(asset name, task object, edit)``, tagged as the JAX package tags the
task), ``TIME_LIMIT`` and ``CONTROL_TIMESTEP`` (``None``: the model's own
timestep).  The asset
name is a compiled model under ``assets/``, written by
``tools/export_torch_assets.py`` from the JAX package's compiler; the
edit (``Model -> Model``) replaces the fields in which a task's model
differs from the asset (lqr's seeded stiffness, the size of dog's floor).
"""

from __future__ import annotations

import os

import torch

from dm_control_torch.physics import model_io
from dm_control_torch.physics.model import Data, Model
from dm_control_torch.rl import control

# Column codes for 3x3 frame access ('xx'..'zz').
_MAT = {c1 + c2: (i, j)
        for i, c1 in enumerate("xyz") for j, c2 in enumerate("xyz")}
_XYZ = {"x": 0, "y": 1, "z": 2}
_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets")


def asset_path(asset: str) -> str:
    return os.path.join(_ASSET_DIR, asset + ".npz")


def load_model(asset: str, device, dtype: torch.dtype, edit=None) -> Model:
    """The compiled model ``assets/<asset>.npz`` on ``device`` in
    ``dtype``, through ``edit`` where one is given."""
    m = model_io.load(asset_path(asset), device, dtype)
    return m if edit is None else edit(m)


class Task(control.Task):
    """Suite task: named accessors return (B, ...) tensors.

    ``observation_stages`` is "vel" for the suite (observation, reward and
    termination read only position- and velocity-stage values), so
    ``BatchEnv`` recomputes only that much after a step; a domain that
    reads acceleration-stage sensors (hopper's touch) sets "acc"."""

    observation_stages = "vel"

    @staticmethod
    def xmat(m: Model, d: Data, body: str, code: str):
        i, j = _MAT[code]
        return d.xmat[:, m.names.body[body], i, j]

    @staticmethod
    def xpos(m: Model, d: Data, body: str, axis: str = None):
        p = d.xpos[:, m.names.body[body]]
        return p if axis is None else p[:, _XYZ[axis]]

    @staticmethod
    def xipos(m: Model, d: Data, body: str, axis: str = None):
        p = d.xipos[:, m.names.body[body]]
        return p if axis is None else p[:, _XYZ[axis]]

    @staticmethod
    def geom_xpos(m: Model, d: Data, geom: str):
        return d.geom_xpos[:, m.names.geom[geom]]

    @staticmethod
    def site_xpos(m: Model, d: Data, site: str):
        return d.site_xpos[:, m.names.site[site]]

    @staticmethod
    def joint_qpos(m: Model, d: Data, joint: str):
        return d.qpos[:, m.jnt_qposadr[m.names.joint[joint]]]

    @staticmethod
    def sensordata(m: Model, d: Data, sensor: str):
        s = m.names.sensor[sensor]
        adr, dim = m.sensor_adr[s], m.sensor_dim[s]
        return d.sensordata[:, adr:adr + dim]

    @staticmethod
    def set_joint_qpos(m: Model, qpos, joint: str, value):
        """qpos (B, nq) with the joint's column set to ``value`` (B,)."""
        qpos = qpos.clone()
        qpos[:, m.jnt_qposadr[m.names.joint[joint]]] = value
        return qpos
