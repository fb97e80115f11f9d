"""Shared manipulation infrastructure (counterpart of
``dm_control_tpu/manipulation/shared/``)."""
