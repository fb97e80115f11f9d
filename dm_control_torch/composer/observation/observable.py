"""Observable definitions (counterpart of
``dm_control_tpu/composer/observation/observable.py``).

Reference: dm_control/composer/observation/observable/base.py:57-241 — an
observable wraps a callable over physics with scheduling (update_interval),
buffering (buffer_size), latency (delay), noise (corruptor), and reduction
(aggregator) options.  The callables read the port's ``Physics`` through
``named_field``, which copies from the device to the host.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np

from dm_control_torch.rl import specs

_AGGREGATORS = {
    "min": functools.partial(np.min, axis=0),
    "max": functools.partial(np.max, axis=0),
    "mean": functools.partial(np.mean, axis=0),
    "median": functools.partial(np.median, axis=0),
    "sum": functools.partial(np.sum, axis=0),
}


class Observable:
    """Base observable (reference observable/base.py:57)."""

    def __init__(self, update_interval=1, buffer_size=None, delay=None,
                 aggregator=None, corruptor=None):
        self._update_interval = update_interval
        self._buffer_size = buffer_size
        self._delay = delay
        self._aggregator = aggregator
        self._corruptor = corruptor
        self._enabled = False

    update_interval = property(lambda self: self._update_interval)
    buffer_size = property(lambda self: self._buffer_size)
    delay = property(lambda self: self._delay)
    aggregator = property(
        lambda self: (_AGGREGATORS[self._aggregator]
                      if isinstance(self._aggregator, str)
                      else self._aggregator))
    corruptor = property(lambda self: self._corruptor)

    @update_interval.setter
    def update_interval(self, value):
        self._update_interval = value

    @buffer_size.setter
    def buffer_size(self, value):
        self._buffer_size = value

    @delay.setter
    def delay(self, value):
        self._delay = value

    @aggregator.setter
    def aggregator(self, value):
        self._aggregator = value

    @corruptor.setter
    def corruptor(self, value):
        self._corruptor = value

    @property
    def enabled(self):
        return self._enabled

    @enabled.setter
    def enabled(self, value):
        self._enabled = bool(value)

    def observation_callable(self, physics, random_state=None):
        """Returns a no-arg callable producing the (possibly corrupted)
        observation value."""
        raw_callable = self._callable(physics)
        if self._corruptor is not None:
            def corrupted():
                return self._corruptor(raw_callable(),
                                       random_state=random_state)
            return corrupted
        return raw_callable

    def __call__(self, physics, random_state=None):
        return self.observation_callable(physics, random_state)()

    def _callable(self, physics) -> Callable:
        raise NotImplementedError

    def configure(self, **kwargs):
        """Bulk-sets options (reference base.py:148)."""
        for key, value in kwargs.items():
            if key not in ("update_interval", "buffer_size", "delay",
                           "aggregator", "corruptor", "enabled"):
                raise KeyError(f"Cannot add attribute {key} to Observable.")
            setattr(self, key, value)


class Generic(Observable):
    """Wraps ``raw_observation_callable(physics)``
    (reference base.py:156)."""

    def __init__(self, raw_observation_callable, **kwargs):
        self._raw_callable = raw_observation_callable
        super().__init__(**kwargs)

    def _callable(self, physics):
        return lambda: self._raw_callable(physics)


class MujocoCamera(Observable):
    """Pixel observable rendered from a named model camera through
    ``physics.render``, on the physics' device (reference
    observable/base.py:241-308)."""

    def __init__(self, camera_name, height=240, width=320, depth=False,
                 **kwargs):
        self._camera_name = camera_name
        self._height = height
        self._width = width
        self._depth = depth
        self._n_channels = 1 if depth else 3
        self._dtype = np.float32 if depth else np.uint8
        super().__init__(**kwargs)

    height = property(lambda self: self._height)
    width = property(lambda self: self._width)

    @height.setter
    def height(self, value):
        self._height = value

    @width.setter
    def width(self, value):
        self._width = value

    @property
    def array_spec(self):
        return specs.Array(
            shape=(self._height, self._width, self._n_channels),
            dtype=self._dtype)

    def _callable(self, physics):
        def observe():
            img = physics.render(self._height, self._width,
                                 self._camera_name, depth=self._depth)
            if self._depth:
                img = np.asarray(img, np.float32)[..., None]
            return img
        return observe


class MJCFFeature(Observable):
    """Observes a named Data field slice (replaces the PyMJCF binding view
    of reference observable/mjcf.py:43)."""

    def __init__(self, kind, entity_or_names, index=None, **kwargs):
        """``kind``: a Data field name ('qpos', 'xpos', 'sensordata'...);
        ``entity_or_names``: names to resolve through the model's NameMap
        (or a callable physics -> array)."""
        self._kind = kind
        self._names = entity_or_names
        self._index = index
        super().__init__(**kwargs)

    def _callable(self, physics):
        kind = self._kind
        names = self._names
        index = self._index

        def observe():
            value = physics.named_field(kind, names)
            if index is not None:
                value = value[index]
            return np.asarray(value)

        return observe
