"""The place tasks (counterpart of
``dm_control_tpu/manipulation/place.py``): registered under the JAX
package's names and tags; they run on composer's host path only, as in
the JAX package, which the port does not have yet (ROADMAP A5)."""

from __future__ import annotations

from dm_control_torch.manipulation.shared import registry

_F, _V = registry.tags.FEATURES, registry.tags.VISION

registry.add_host_only(
    ("place_brick_features", _F), ("place_brick_vision", _V),
    ("place_cradle_features", _F), ("place_cradle_vision", _V))
