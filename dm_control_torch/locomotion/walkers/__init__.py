"""Locomotion walkers (counterpart of
``dm_control_tpu/locomotion/walkers/``): the ant, the rolling and jumping
balls, the CMU humanoids of 2019 (torque and position actuators) and
2020, and the rat (BoxHead is ``locomotion/soccer/boxhead.py``), with the
helpers that rescale a walker's tree (``rescale``) and add scaled
actuators (``scaled_actuators``)."""

from dm_control_torch.locomotion.walkers.ant import Ant  # noqa: F401
from dm_control_torch.locomotion.walkers.cmu_humanoid import (  # noqa: F401
    CMUHumanoid, CMUHumanoidPositionControlled,
    CMUHumanoidPositionControlledV2020,
)
from dm_control_torch.locomotion.walkers.jumping_ball import (  # noqa: F401
    JumpingBallWithHead, RollingBallWithHead,
)
from dm_control_torch.locomotion.walkers.rodent import Rat  # noqa: F401
from dm_control_torch.locomotion.walkers import rescale  # noqa: F401
from dm_control_torch.locomotion.walkers import scaled_actuators  # noqa: F401
