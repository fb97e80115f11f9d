"""Locomotion arenas, as names (counterpart of
``dm_control_tpu/locomotion/arenas/``)."""

from dm_control_torch.locomotion.arenas.floors import Floor  # noqa: F401
