"""Mocap clip collections (counterpart of
``dm_control_tpu/locomotion/mocap/types.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ClipCollection:
    """A set of clips with optional per-clip windows and sampling weights."""

    ids: Tuple[str, ...]
    start_steps: Optional[Tuple[int, ...]] = None
    end_steps: Optional[Tuple[int, ...]] = None
    weights: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        n = len(self.ids)
        if self.start_steps is None:
            object.__setattr__(self, "start_steps", (0,) * n)
        if self.weights is None:
            object.__setattr__(self, "weights", (1.0,) * n)
        if len(self.start_steps) != n or len(self.weights) != n:
            raise ValueError("Inconsistent ClipCollection field lengths.")
        if self.end_steps is not None and len(self.end_steps) != n:
            raise ValueError("Inconsistent ClipCollection field lengths.")
