"""Locomotion arenas (counterpart of
``dm_control_tpu/locomotion/arenas/``): the floor.  The corridors, the
bowl, the mazes and the covering are not ported (ROADMAP A5.5)."""

from dm_control_torch.locomotion.arenas.floors import Floor  # noqa: F401
