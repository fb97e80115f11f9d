"""Mocap-driven walker initializers (counterpart of
``dm_control_tpu/locomotion/walkers/initializers/mocap.py``; reference:
dm_control/locomotion/walkers/initializers/mocap.py)."""

from __future__ import annotations

import numpy as np

from dm_control_torch.locomotion.mocap import loader as loader_lib
from dm_control_torch.locomotion.walkers.initializers import (
    WalkerInitializer, _reset_walker_joints,
)


class CMUMocapInitializer(WalkerInitializer):
    """Puts the walker at a random frame of a mocap clip.

    The clip is ``mocap_key`` of the CMU h5 of ``version`` where
    ``loader.cmu_mocap_path`` finds the file and it has the key; otherwise
    it is the synthetic walking clip sized to each walker's joints, the
    clip the JAX package uses then."""

    def __init__(self, mocap_key="CMU_077_02", version="2019"):
        self._trajectory = None
        try:
            path = loader_lib.cmu_mocap_path(version)
            ldr = loader_lib.HDF5TrajectoryLoader(path)
            self._trajectory = ldr.get_trajectory(mocap_key)
        except (FileNotFoundError, KeyError):
            pass  # the synthetic clip, per walker at initialization

    def _clip_for(self, physics, walker):
        if self._trajectory is not None:
            return self._trajectory
        prefix = walker.name + "/"
        njoint = sum(1 for jname in physics.model.names.joint
                     if jname.startswith(prefix)
                     and not jname.endswith("_root"))
        return loader_lib.synthetic_walking_trajectory(
            nq=njoint + 7, nv=njoint + 6)

    def initialize_pose(self, physics, walker, random_state):
        clip = self._clip_for(physics, walker)
        step = random_state.randint(clip.num_steps)
        frame = clip.get_timestep_data(step)
        qpos = np.asarray(frame["qpos"]).ravel()
        qvel = np.asarray(frame["qvel"]).ravel()
        _reset_walker_joints(physics, walker, qpos[7:])
        try:
            walker.set_pose(physics, position=qpos[:3],
                            quaternion=qpos[3:7])
            walker.set_velocity(physics, velocity=qvel[:3],
                                angular_velocity=qvel[3:6])
        except (ValueError, KeyError):
            pass  # planar-rooted walkers have no free joint
