"""Preconfigured rodent environments (counterpart of
``dm_control_tpu/locomotion/examples/basic_rodent_2020.py``;
reference: dm_control/locomotion/examples/basic_rodent_2020.py:37-140)."""

from dm_control_torch.locomotion.examples.basic import (  # noqa: F401
    rodent_escape_bowl,
    rodent_maze_forage,
    rodent_run_gaps,
    rodent_two_touch,
)
