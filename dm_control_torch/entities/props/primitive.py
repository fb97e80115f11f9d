"""A single-geom free prop, as names.

Counterpart of ``dm_control_tpu/entities/props/primitive.py``: the body
``<name>/body`` with the geom ``<name>/geom``; added to an arena as a free
entity it moves on the free joint ``<name>/body_root``.
"""

from __future__ import annotations


class Primitive:
    """A single-geom prop (sphere, box, capsule, ...)."""

    def __init__(self, name="prop"):
        self.name = name
