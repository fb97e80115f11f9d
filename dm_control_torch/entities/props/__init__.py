"""Props (counterpart of ``dm_control_tpu/entities/props/``)."""
