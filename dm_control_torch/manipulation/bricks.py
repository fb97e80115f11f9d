"""The brick stacking and reassembly tasks (counterpart of
``dm_control_tpu/manipulation/bricks.py``): registered under the JAX
package's names and tags; they run on composer's host path only, as in
the JAX package, which the port does not have yet (ROADMAP A5)."""

from __future__ import annotations

from dm_control_torch.manipulation.shared import registry

_F, _V = registry.tags.FEATURES, registry.tags.VISION

registry.add_host_only(
    ("stack_2_bricks_features", _F), ("stack_2_bricks_vision", _V),
    ("stack_2_bricks_moveable_base_features", _F),
    ("stack_2_bricks_moveable_base_vision", _V),
    ("stack_3_bricks_features", _F), ("stack_3_bricks_vision", _V),
    ("stack_3_bricks_random_order_features", _F),
    ("stack_2_of_3_bricks_random_order_features", _F),
    ("stack_2_of_3_bricks_random_order_vision", _V),
    ("reassemble_3_bricks_fixed_order_features", _F),
    ("reassemble_3_bricks_fixed_order_vision", _V),
    ("reassemble_5_bricks_random_order_features", _F),
    ("reassemble_5_bricks_random_order_vision", _V))
