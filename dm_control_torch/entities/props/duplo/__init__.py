"""A 2x4 Duplo brick, as names.

Counterpart of ``dm_control_tpu/entities/props/duplo/__init__.py``: the
body ``<name>/brick`` on the free joint ``<name>/brick_root`` once added
to an arena, and the sensors on its ``bounding_box`` site (frame
position, orientation, linear and angular velocity, and force).
"""

from __future__ import annotations


class Duplo:
    """A 2x4 Duplo brick (reference duplo/__init__.py:50)."""

    def __init__(self, name="duplo"):
        self.name = name
