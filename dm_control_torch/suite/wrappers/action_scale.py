"""Affine remapping of the action interface onto new bounds.

Behavioral parity with dm_control/suite/wrappers/action_scale.py: the
wrapper advertises ``[minimum, maximum]`` as its action bounds and maps
incoming actions affinely onto the wrapped environment's native bounds,
precomputed once as dense ``gain``/``bias`` arrays at the spec's shape.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.rl import specs
from dm_control_torch.suite.wrappers.base import DelegatingWrapper


def _as_full_shape(value, shape, label):
    """Validates and broadcasts a bounds array to the spec's full shape."""
    arr = np.asarray(value)
    if not np.isfinite(arr).all():
        raise ValueError(f"{label} contains non-finite entries: {arr!r}")
    try:
        return np.broadcast_to(arr, shape)
    except ValueError as exc:
        raise ValueError(
            f"{label} has shape {arr.shape}, not broadcastable to the "
            f"action shape {shape}") from exc


class Wrapper(DelegatingWrapper):
    """Rescales actions from [minimum, maximum] to the env's own bounds."""

    def __init__(self, env, minimum, maximum):
        super().__init__(env)
        inner = env.action_spec()
        if not isinstance(inner, specs.BoundedArray):
            raise ValueError(
                "action_scale.Wrapper needs a single BoundedArray action "
                f"spec; the wrapped env returned {type(inner).__name__}: "
                f"{inner}")
        lo = _as_full_shape(minimum, inner.shape, "minimum")
        hi = _as_full_shape(maximum, inner.shape, "maximum")
        inner_lo = _as_full_shape(inner.minimum, inner.shape,
                                  "env.action_spec().minimum")
        inner_hi = _as_full_shape(inner.maximum, inner.shape,
                                  "env.action_spec().maximum")
        # action -> inner_lo + (action - lo) * gain, as a * gain + bias
        self._gain = (inner_hi - inner_lo) / (hi - lo)
        self._bias = inner_lo - lo * self._gain
        self._inner_dtype = inner.dtype
        self._spec = inner.replace(
            minimum=np.asarray(minimum), maximum=np.asarray(maximum),
            dtype=np.result_type(lo, hi, inner.dtype))

    def step(self, action):
        mapped = np.asarray(action) * self._gain + self._bias
        return self._env.step(mapped.astype(self._inner_dtype, copy=False))

    def action_spec(self):
        return self._spec
