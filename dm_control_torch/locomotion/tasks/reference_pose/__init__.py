"""Mocap tracking tasks, batched (counterpart of
``dm_control_tpu/locomotion/tasks/reference_pose/``)."""

from dm_control_torch.locomotion.tasks.reference_pose import rewards  # noqa: F401
from dm_control_torch.locomotion.tasks.reference_pose.tracking import (  # noqa: F401
    MultiClipMocapTracking, ReferencePosesTask,
)
from dm_control_torch.locomotion.tasks.reference_pose import datasets  # noqa: F401
