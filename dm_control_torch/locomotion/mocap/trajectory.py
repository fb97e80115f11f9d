"""A mocap trajectory: arrays of features over time (counterpart of
``dm_control_tpu/locomotion/mocap/trajectory.py``)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class Trajectory:
    """Arrays keyed by feature name, the first axis time."""

    def __init__(self, features: Dict[str, np.ndarray], dt: float = 0.03,
                 identifier: str = ""):
        lengths = {k: len(v) for k, v in features.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"Inconsistent feature lengths: {lengths}")
        self._features = {k: np.asarray(v) for k, v in features.items()}
        self._dt = dt
        self._identifier = identifier

    @property
    def identifier(self):
        return self._identifier

    @property
    def dt(self):
        return self._dt

    @property
    def num_steps(self):
        return len(next(iter(self._features.values())))

    @property
    def duration(self):
        return (self.num_steps - 1) * self._dt

    def keys(self):
        return self._features.keys()

    def __getitem__(self, key):
        return self._features[key]

    def get_timestep_data(self, step: int) -> Dict[str, np.ndarray]:
        return {k: v[step] for k, v in self._features.items()}

    def sub_trajectory(self, start_step: int,
                       end_step: Optional[int] = None) -> "Trajectory":
        """The frames from ``start_step`` up to ``end_step``."""
        end_step = end_step if end_step is not None else self.num_steps
        return Trajectory(
            {k: v[start_step:end_step] for k, v in self._features.items()},
            dt=self._dt, identifier=self._identifier)

    def as_zeroed_velocity(self) -> "Trajectory":
        """The same trajectory with its velocity features zeroed."""
        out = {}
        for k, v in self._features.items():
            if "velocity" in k or k == "qvel" or "angular" in k:
                out[k] = np.zeros_like(v)
            else:
                out[k] = v
        return Trajectory(out, dt=self._dt, identifier=self._identifier)
