"""Manipulation task registry
(counterpart of ``dm_control_tpu/manipulation/shared/registry.py``).

A registered factory returns the task, a composer ``Task`` over its own
entity tree (the JAX package's factories return it inside a
``composer.Environment``; here ``manipulation.load`` builds that, on the
device it is asked for).  The registry holds the JAX package's 25 names
with their tags.
"""

from __future__ import annotations

from dm_control_torch.utils import containers


class tags:  # noqa: N801 (reference API name)
    FEATURES = "features"
    VISION = "vision"
    EASY = "easy"


_REGISTRY = containers.TaggedTasks(allow_overriding_keys=False)

add = _REGISTRY.add


def get_all_names():
    return tuple(_REGISTRY)


def get_tags():
    return tuple(_REGISTRY.tags())


def get_names_by_tag(tag):
    return tuple(_REGISTRY.tagged(tag))


def get(name):
    return _REGISTRY[name]
