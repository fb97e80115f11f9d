"""Observable and property decorators (counterpart of
``dm_control_tpu/composer/define.py``; reference
dm_control/composer/define.py)."""

from __future__ import annotations

import threading


class cached_property(property):  # noqa: N801 (reference API name)
    """Thread-safe, write-once cached property
    (reference define.py:22-46)."""

    def __init__(self, func):
        super().__init__(func)
        self._lock = threading.RLock()

    def __get__(self, obj, cls=None):
        if obj is None:
            return self
        name = self.fget.__name__
        obj_dict = obj.__dict__
        try:
            return obj_dict[name]
        except KeyError:
            with self._lock:
                # double-checked locking
                try:
                    return obj_dict[name]
                except KeyError:
                    value = self.fget(obj)
                    obj_dict[name] = value
                    return value


class observable(property):  # noqa: N801 (reference API name)
    """Decorator marking a method as defining an Observable
    (reference define.py:55)."""
