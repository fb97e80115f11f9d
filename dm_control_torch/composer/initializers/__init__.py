"""Episode initializers (counterpart of
``dm_control_tpu/composer/initializers/``; reference:
dm_control/composer/initializers/): props placed where they touch
nothing, and an arm's tool centre point put at a drawn pose by inverse
kinematics."""

from dm_control_torch.composer.initializers import (  # noqa: F401
    prop_initializer, tcp_initializer,
)

PropPlacer = prop_initializer.PropPlacer
ToolCenterPointInitializer = tcp_initializer.ToolCenterPointInitializer
