"""Locomotion walkers (counterpart of
``dm_control_tpu/locomotion/walkers/``): the rolling and jumping balls and
the CMU 2020 humanoid (BoxHead is ``locomotion/soccer/boxhead.py``).  The
ant, the rodent, the 2019 CMU humanoid and the rescaling helpers are not
ported (ROADMAP A5.5)."""

from dm_control_torch.locomotion.walkers.cmu_humanoid import (  # noqa: F401
    CMUHumanoidPositionControlledV2020,
)
from dm_control_torch.locomotion.walkers.jumping_ball import (  # noqa: F401
    JumpingBallWithHead, RollingBallWithHead,
)
