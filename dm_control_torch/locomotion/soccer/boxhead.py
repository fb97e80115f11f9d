"""The BoxHead walker, as names (counterpart of
``dm_control_tpu/locomotion/soccer/boxhead.py``).

A wheeled robot on three slide joints (``root_x``, ``root_y``,
``root_z``) that turns on its ``steer`` hinge, with a kick and a roll
joint; in a compiled match every name is prefixed with the walker's
(``home0/steer``).
"""

from __future__ import annotations

class BoxHead:
    """A BoxHead player named ``name``."""

    def __init__(self, name="boxhead"):
        self.name = name

    @property
    def root_body_name(self):
        return "head_body"

    @property
    def observable_joint_names(self):
        return ("steer", "kick", "roll")
