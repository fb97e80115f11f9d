"""Viewer utilities (counterpart of ``dm_control_tpu/viewer/util.py``;
reference: dm_control/viewer/util.py)."""

from __future__ import annotations

import contextlib
import time


class QuietSet(set):
    """A set of listeners; += / -= add and remove (reference util.py)."""

    def __iadd__(self, other):
        self.add(other)
        return self

    def __isub__(self, other):
        self.discard(other)
        return self


class ErrorLogger:
    """Context manager that traps exceptions and notifies listeners
    (reference util.py ErrorLogger)."""

    def __init__(self, listeners):
        self._listeners = listeners
        self._error_found = False

    @property
    def errors_found(self):
        return self._error_found

    def __enter__(self):
        self._error_found = False
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self._error_found = True
            for listener in self._listeners:
                listener(exc)
            return True  # absorb
        return False


class Timer:
    """Measures wall time of a block (reference util.py Timer)."""

    def __init__(self):
        self.measured_time = 0.0

    @contextlib.contextmanager
    def measure_time(self):
        t0 = time.perf_counter()
        yield
        self.measured_time = time.perf_counter() - t0


class TimeMultiplier:
    """Relative simulation speed vs realtime (reference util.py:96)."""

    MIN = 1.0 / 32
    MAX = 4.0

    def __init__(self, initial_time_multiplier=1.0):
        self._factor = 1.0
        self.set(initial_time_multiplier)

    def get(self):
        return self._factor

    def set(self, value):
        self._factor = max(self.MIN, min(self.MAX, value))

    def increase(self):
        self.set(self._factor * 2.0)

    def decrease(self):
        self.set(self._factor / 2.0)

    def __str__(self):
        if self._factor >= 1.0:
            return f"{self._factor:.0f}"
        return f"1/{1.0 / self._factor:.0f}"


class Integrator:
    """Averages a value over a refresh period (reference util.py:138)."""

    def __init__(self, refresh_rate=0.5):
        self._refresh = refresh_rate
        self._sum = 0.0
        self._n = 0
        self._avg = 0.0
        self._t0 = time.perf_counter()

    @property
    def value(self):
        return self._avg

    @value.setter
    def value(self, v):
        self._sum += v
        self._n += 1
        now = time.perf_counter()
        if now - self._t0 >= self._refresh:
            self._avg = self._sum / self._n
            self._sum, self._n = 0.0, 0
            self._t0 = now
