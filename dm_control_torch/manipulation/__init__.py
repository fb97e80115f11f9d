"""The manipulation tasks on PyTorch (counterpart of
``dm_control_tpu/manipulation/__init__.py``; reference:
dm_control/manipulation/__init__.py:24-56).

The registry holds the JAX package's 25 names with their tags (``ALL``,
``TAGS``, ``get_environments_by_tag``).  Each task builds its own entity
tree (the Jaco arm and hand in the standard arena, with its props), which
the port compiles.  ``load`` gives any of them as a single
``composer.Environment``, composer's host path.  Eight of them also run
on the batched path, ``load_batch``: ``reach_site``, ``reach_duplo``,
``lift_brick`` and ``lift_large_box``, each as ``_features`` and
``_vision``.  A ``_vision`` variant has the physics of its ``_features``
variant without the privileged prop state among its observations (as in
the JAX package, no camera observable is added: ``Physics.render`` and
``composer.observation.MujocoCamera`` render one where a caller adds the
camera, ``shared.cameras.add_camera_observables``; on the batched path
both variants observe the same keys).
"""

from __future__ import annotations

import torch

from dm_control_torch import composer
from dm_control_torch.composer.batch import compile_task, implements_batch
from dm_control_torch.manipulation import bricks  # noqa: F401
from dm_control_torch.manipulation import lift  # noqa: F401
from dm_control_torch.manipulation import place  # noqa: F401
from dm_control_torch.manipulation import reach  # noqa: F401
from dm_control_torch.manipulation.shared import registry as _registry
from dm_control_torch.suite import check_device

ALL = _registry.get_all_names()
TAGS = _registry.get_tags()


def get_environments_by_tag(tag):
    """Names of environments carrying ``tag``."""
    return tuple(_registry.get_names_by_tag(tag))


def load(environment_name, seed=None, *, device="cuda",
         dtype: torch.dtype = torch.float64):
    """The named task as a single ``composer.Environment`` (reference
    __init__.py:49), its model compiled from the task's entity tree onto
    ``device`` in ``dtype``; ``seed`` seeds its RandomState.  The device is
    the card unless the caller asks for another (``device="cpu"``);
    without CUDA the default raises."""
    task = _registry.get(environment_name)()
    env = composer.Environment(task, time_limit=task.time_limit,
                               device=device, dtype=dtype)
    if seed is not None:
        env.random_state.seed(seed)
    return env


def load_batch(environment_name, *, device="cuda", dtype: torch.dtype,
               time_limit=10.0, autoreset=True, contact_cap=None):
    """A ``BatchEnv`` of a manipulation task, its model compiled from the
    task's entity tree onto ``device`` in ``dtype``.  The device is the
    card unless the caller asks for another (``device="cpu"``); without
    CUDA the default raises.  A task without the batched hooks (stacking,
    reassembling and placing bricks) raises ``TypeError``.
    ``contact_cap`` goes to ``BatchEnv`` (None: 64 in float32, where the
    Jaco models' 654-856 candidate contacts engage it)."""
    task = _registry.get(environment_name)()
    if not implements_batch(task):
        raise TypeError(
            f"{environment_name}: {type(task).__name__} does not implement "
            f"BatchableTask (it runs on composer's host path, "
            f"manipulation.load)")
    check_device(f"manipulation.load_batch({environment_name!r})", device)
    return compile_task(task, device=device, dtype=dtype,
                        time_limit=time_limit, autoreset=autoreset,
                        contact_cap=contact_cap)
