"""Locomotion model literal trees (copies of the JAX package's
``dm_control_tpu/locomotion/models/``)."""
