"""Composer on PyTorch (counterpart of ``dm_control_tpu/composer/``).

The host path, as in the JAX package: entities build MJCF element trees
(``Entity``, ``Arena``), which are merged by attachment and compiled once
per environment onto its device; a ``Task`` over the root entity runs in
``Environment``'s hook pipeline with observables (``observation/``).  The
batched path: the ``BatchableTask`` protocol and ``compile_task``
(``composer/batch.py``).  ``variation/`` draws parameters from a
``RandomState`` (the corridors' layouts).  ``initializers/`` places
props without contact (``PropPlacer``) and an arm's tool centre point by
inverse kinematics (``ToolCenterPointInitializer``).
"""

from dm_control_torch.composer.define import (  # noqa: F401
    cached_property, observable,
)
from dm_control_torch.composer.entity import (  # noqa: F401
    Entity, ModelWrapperEntity, Observables, Robot,
)
from dm_control_torch.composer.arena import Arena  # noqa: F401
from dm_control_torch.composer.task import NullTask, Task  # noqa: F401
from dm_control_torch.composer.environment import (  # noqa: F401
    Environment, EpisodeInitializationError,
)
from dm_control_torch.composer.batch import (  # noqa: F401
    BatchableTask, compile_task,
)
