"""Locomotion props (counterpart of ``dm_control_tpu/locomotion/props/``).
"""
