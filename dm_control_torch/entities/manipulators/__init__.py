"""Robot arms and hands (counterpart of
``dm_control_tpu/entities/manipulators/``)."""
