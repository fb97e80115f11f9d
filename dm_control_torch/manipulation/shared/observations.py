"""Observation settings presets
(counterpart of ``dm_control_tpu/manipulation/shared/observations.py``).

The batched tasks give the same observations under either preset (as in
the JAX package); the presets tell the features and vision variants of a
task apart.
"""

from __future__ import annotations

import collections

ObservableSpec = collections.namedtuple(
    "ObservableSpec",
    ["enabled", "update_interval", "buffer_size", "delay", "aggregator",
     "corruptor"])

ObservationSettings = collections.namedtuple(
    "ObservationSettings", ["proprio", "ftt", "prop_pose", "camera"])

_ENABLED = ObservableSpec(enabled=True, update_interval=1, buffer_size=None,
                          delay=None, aggregator=None, corruptor=None)
_DISABLED = _ENABLED._replace(enabled=False)

# features: all state observables on, no cameras
PERFECT_FEATURES = ObservationSettings(
    proprio=_ENABLED, ftt=_ENABLED, prop_pose=_ENABLED, camera=_DISABLED)
# vision: proprio + camera, no privileged prop state
VISION = ObservationSettings(
    proprio=_ENABLED, ftt=_ENABLED, prop_pose=_DISABLED, camera=_ENABLED)

