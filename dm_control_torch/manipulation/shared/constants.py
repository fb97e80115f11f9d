"""Manipulation constants
(counterpart of ``dm_control_tpu/manipulation/shared/constants.py``)."""

CONTROL_TIMESTEP = 0.04
PHYSICS_TIMESTEP = 0.002

RED = (1.0, 0.0, 0.0, 0.3)
GREEN = (0.0, 1.0, 0.0, 0.3)
BLUE = (0.0, 0.0, 1.0, 0.3)
CYAN = (0.0, 1.0, 1.0, 0.3)
MAGENTA = (1.0, 0.0, 1.0, 0.3)
YELLOW = (1.0, 1.0, 0.0, 0.3)

TASK_SITE_GROUP = 3
