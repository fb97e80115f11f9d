"""Preconfigured CMU-humanoid environments (counterpart of
``dm_control_tpu/locomotion/examples/basic_cmu_2019.py``;
reference: dm_control/locomotion/examples/basic_cmu_2019.py:34-164)."""

from dm_control_torch.locomotion.examples.basic import (  # noqa: F401
    cmu_humanoid_go_to_target,
    cmu_humanoid_heterogeneous_forage,
    cmu_humanoid_maze_forage,
    cmu_humanoid_run_gaps,
    cmu_humanoid_run_walls,
)
