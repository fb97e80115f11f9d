"""Locomotion walkers, as names (counterpart of
``dm_control_tpu/locomotion/walkers/``): the rolling ball and the CMU 2020
humanoid, the two walkers of the ported tracking tasks."""

from dm_control_torch.locomotion.walkers.cmu_humanoid import (  # noqa: F401
    CMUHumanoidPositionControlledV2020,
)
from dm_control_torch.locomotion.walkers.jumping_ball import (  # noqa: F401
    RollingBallWithHead,
)
