"""Suite task base with named access to batched model data.
Counterpart of ``dm_control_tpu/suite/base.py``."""

from __future__ import annotations

from dm_control_torch.physics.model import Data, Model
from dm_control_torch.rl import control

# Column codes for 3x3 frame access ('xx'..'zz').
_MAT = {c1 + c2: (i, j)
        for i, c1 in enumerate("xyz") for j, c2 in enumerate("xyz")}
_XYZ = {"x": 0, "y": 1, "z": 2}


class Task(control.Task):
    """Suite task: named accessors return (B, ...) tensors.

    ``observation_stages`` is "vel" for the suite (observation, reward and
    termination read only position- and velocity-stage values), so
    ``BatchEnv`` recomputes only that much after a step."""

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
    def sensordata(m: Model, d: Data, sensor: str):
        s = m.names.sensor[sensor]
        adr, dim = m.sensor_adr[s], m.sensor_dim[s]
        return d.sensordata[:, adr:adr + dim]
