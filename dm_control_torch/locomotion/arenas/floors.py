"""The floor arena, as names (counterpart of
``dm_control_tpu/locomotion/arenas/floors.py``): a plane named
``groundplane`` of half-size ``size``, with the default friction."""

from __future__ import annotations


class Floor:
    """A flat plane with aligned world axes."""

    def __init__(self, size=(8, 8), name="floor"):
        self.name = name
        self.size = tuple(size)
