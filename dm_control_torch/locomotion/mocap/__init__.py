"""Mocap clips (counterpart of ``dm_control_tpu/locomotion/mocap/``)."""
