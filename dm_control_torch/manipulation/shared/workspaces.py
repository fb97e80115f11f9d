"""Workspace boxes and draws in them
(counterpart of ``dm_control_tpu/manipulation/shared/workspaces.py``)."""

from __future__ import annotations

import collections

import numpy as np

BoundingBox = collections.namedtuple("BoundingBox", ["lower", "upper"])


def uniform_in_box(box: BoundingBox, random_state) -> np.ndarray:
    """A point uniform in ``box``, drawn on the host from a
    ``numpy.random.RandomState`` (the host hooks' draw)."""
    return random_state.uniform(np.asarray(box.lower),
                                np.asarray(box.upper))


def batch_uniform_in_box(m, box: BoundingBox, rc):
    """Points (B, 3) uniform in ``box``, drawn from ``rc`` (an
    ``rl.control.RandomContext``), in the model's dtype on its device."""
    lower = m.const(("box_lower", tuple(box.lower)), box.lower)
    upper = m.const(("box_upper", tuple(box.upper)), box.upper)
    return rc.uniform(lower, upper, 3)

