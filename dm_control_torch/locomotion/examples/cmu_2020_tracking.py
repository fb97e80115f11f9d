"""The CMU 2020 humanoid tracking the walk_tiny clips (counterpart of
``dm_control_tpu/locomotion/examples/cmu_2020_tracking.py``; reference:
dm_control/locomotion/examples/cmu_2020_tracking.py).

The clips are walk_tiny's in the CMU 2020 h5 where
``loader.cmu_mocap_path(version="2020")`` finds the file, else three
synthetic walking clips (seeds 0-2), as in the JAX package.  The
environment compiles onto ``device`` (the card unless the caller asks for
another, ``device="cpu"``) in ``dtype``.
"""

from __future__ import annotations

import torch

from dm_control_torch import composer
from dm_control_torch.locomotion.arenas import Floor
from dm_control_torch.locomotion.mocap import loader as loader_lib
from dm_control_torch.locomotion.tasks.reference_pose import (
    datasets, tracking,
)
from dm_control_torch.locomotion.walkers.cmu_humanoid import (
    CMUHumanoidPositionControlledV2020,
)
from dm_control_torch.suite import check_device


def _walk_trajectories(walker):
    """{id: Trajectory}: walk_tiny's clips of the CMU 2020 h5 that the file
    has, or the synthetic bank where there is no file."""
    try:
        path = loader_lib.cmu_mocap_path(version="2020")
    except FileNotFoundError:
        njoint = len(walker.mocap_joint_names)
        return {f"synthetic_walk_{k}": loader_lib.
                synthetic_walking_trajectory(
                    nq=njoint + 7, nv=njoint + 6, seed=k,
                    identifier=f"synthetic_walk_{k}")
                for k in range(3)}
    ldr = loader_lib.HDF5TrajectoryLoader(path)
    collection = datasets.get_dataset("walk_tiny", loader=ldr)
    return {i: ldr.get_trajectory(i) for i in collection.ids}


def cmu_humanoid_tracking(random_state=None, *, device="cuda",
                          dtype: torch.dtype = torch.float64):
    """The CMU 2020 humanoid on a ``Floor`` tracking ``_walk_trajectories``
    (``ref_steps`` 1-5, ``min_steps`` 10, the CoMic reward, 30 s)."""
    check_device("examples.cmu_2020_tracking.cmu_humanoid_tracking", device)
    walker = CMUHumanoidPositionControlledV2020()
    task = tracking.MultiClipMocapTracking(
        walker=walker,
        arena=Floor(),
        ref_path_or_trajectories=_walk_trajectories(walker),
        ref_steps=(1, 2, 3, 4, 5),
        min_steps=10,
        reward_type="comic",
    )
    return composer.Environment(task, time_limit=30,
                                random_state=random_state,
                                strip_singleton_obs_buffer_dim=True,
                                device=device, dtype=dtype)
