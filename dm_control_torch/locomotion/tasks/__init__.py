"""Locomotion tasks (counterpart of ``dm_control_tpu/locomotion/tasks/``):
mocap tracking, batched."""
