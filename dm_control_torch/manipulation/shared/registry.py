"""Manipulation task registry
(counterpart of ``dm_control_tpu/manipulation/shared/registry.py``).

A registered factory returns the task.  The tasks that run only on
composer's host path in the JAX package (stacking and placing bricks) are
registered as ``HostOnlyTask``s under their names and tags, so the
registry holds all 25 of the JAX package's names.
"""

from __future__ import annotations

from dm_control_torch.utils import containers


class tags:  # noqa: N801 (reference API name)
    FEATURES = "features"
    VISION = "vision"
    EASY = "easy"


_REGISTRY = containers.TaggedTasks(allow_overriding_keys=False)

add = _REGISTRY.add


class HostOnlyTask:
    """A task of composer's host path, which the port does not have yet
    (ROADMAP A5): ``compile_task`` refuses it (it is no
    ``BatchableTask``)."""

    def __init__(self, name):
        self.name = name


def add_host_only(*entries):
    """Registers ``(name, tag)`` entries whose factories return a
    ``HostOnlyTask``."""
    for name, tag in entries:
        def factory(name=name):
            return HostOnlyTask(name)
        factory.__name__ = name
        add(tag)(factory)


def get_all_names():
    return tuple(_REGISTRY)


def get_tags():
    return tuple(_REGISTRY.tags())


def get_names_by_tag(tag):
    return tuple(_REGISTRY.tagged(tag))


def get(name):
    return _REGISTRY[name]
