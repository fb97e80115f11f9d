"""Mocap clips for tests and benchmarks (counterpart of
``dm_control_tpu/locomotion/mocap/loader.py``).

The HDF5 and protobuf loaders of recorded clips wait for clip files in
the repository (ROADMAP A5.4); ``synthetic_walking_trajectory`` makes the
JAX package's synthetic clip, the same numbers under the same seed.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.locomotion.mocap.trajectory import Trajectory


def synthetic_walking_trajectory(nq: int, nv: int, num_steps: int = 120,
                                 dt: float = 0.03,
                                 identifier: str = "synthetic_walk",
                                 seed: int = 0) -> Trajectory:
    """A smooth clip: the root walking forward at 0.6 m/s, 1.2 m up,
    upright, and every other joint on a sine of 1 Hz with a drawn phase
    and amplitude (phases first, then amplitudes, from
    ``RandomState(seed)``)."""
    rng = np.random.RandomState(seed)
    t = np.arange(num_steps) * dt
    qpos = np.zeros((num_steps, nq))
    qvel = np.zeros((num_steps, nv))
    qpos[:, 0] = 0.6 * t
    qpos[:, 2] = 1.2
    qpos[:, 3] = 1.0
    phases = rng.uniform(0, 2 * np.pi, max(nq - 7, 0))
    amps = rng.uniform(0.05, 0.3, max(nq - 7, 0))
    for j in range(nq - 7):
        qpos[:, 7 + j] = amps[j] * np.sin(2 * np.pi * t + phases[j])
        qvel[:, 6 + j] = (amps[j] * 2 * np.pi
                          * np.cos(2 * np.pi * t + phases[j]))
    qvel[:, 0] = 0.6
    return Trajectory({"qpos": qpos, "qvel": qvel}, dt=dt,
                      identifier=identifier)
