"""The manipulation tasks on PyTorch (counterpart of
``dm_control_tpu/manipulation/__init__.py``).

The registry holds the JAX package's 25 names with their tags (``ALL``,
``TAGS``, ``get_environments_by_tag``).  Eight of them run on the batched
path, ``load_batch``: ``reach_site``, ``reach_duplo``, ``lift_brick`` and
``lift_large_box``, each as ``_features`` and ``_vision`` (the two
variants share their physics and their observations; pixels are not
ported).  The others, stacking and placing bricks, and ``load``, the
single environment of any of them, run on composer's host path, which is
not ported yet (ROADMAP A5).
"""

from __future__ import annotations

import torch

from dm_control_torch.composer.batch import BatchableTask, compile_task
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


def load(environment_name, seed=None):
    """The single environment of a manipulation task: composer's host
    path, not ported yet."""
    del seed
    _registry.get(environment_name)  # KeyError for an unknown name
    raise NotImplementedError(
        f"manipulation.load({environment_name!r}): composer's host path "
        f"(environment, task, entity, observables) is not ported yet "
        f"(ROADMAP A5); load_batch runs the batchable tasks")


def load_batch(environment_name, *, device="cuda", dtype: torch.dtype,
               time_limit=10.0, autoreset=True, contact_cap=None):
    """A ``BatchEnv`` of a manipulation task, its model on ``device`` in
    ``dtype``.  The device is the card unless the caller asks for another
    (``device="cpu"``); without CUDA the default raises.  A task that does
    not implement ``composer.BatchableTask`` raises ``TypeError``.
    ``contact_cap`` goes to ``BatchEnv`` (None: 64 in float32, where the
    Jaco models' 654-856 candidate contacts engage it)."""
    task = _registry.get(environment_name)()
    if not isinstance(task, BatchableTask):
        raise TypeError(
            f"{environment_name}: {type(task).__name__} does not implement "
            f"BatchableTask (composer's host path, ROADMAP A5)")
    check_device(f"manipulation.load_batch({environment_name!r})", device)
    return compile_task(task, device=device, dtype=dtype,
                        time_limit=time_limit, autoreset=autoreset,
                        contact_cap=contact_cap)
