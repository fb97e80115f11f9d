"""Observation system (counterpart of
``dm_control_tpu/composer/observation/``)."""

from dm_control_torch.composer.observation.observable import (  # noqa: F401
    Generic, MJCFFeature, MujocoCamera, Observable,
)
from dm_control_torch.composer.observation.obs_buffer import (  # noqa: F401
    Buffer,
)
from dm_control_torch.composer.observation.updater import Updater  # noqa: F401
