"""Entities (counterpart of ``dm_control_tpu/entities/``; reference:
dm_control/entities/): composer entities that build their MJCF trees
with the port's ``mjcf`` layer."""
