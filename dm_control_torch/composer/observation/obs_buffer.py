"""Ring buffer for delayed / aggregated observations (counterpart of
``dm_control_tpu/composer/observation/obs_buffer.py``).

Reference: dm_control/composer/observation/obs_buffer.py:46-199.  Faithful
semantics: an "arrived" deque of exactly ``buffer_size`` slots (pre-filled
with pad values) that new observations enter in ARRIVAL order, plus a
"pending" deque ordered by arrival time that supports out-of-order
insertion; ``drop_unobserved_upcoming_items`` simulates the upcoming
control period and prunes scheduled captures that would be pushed out of
the arrived window before any read could see them.
"""

from __future__ import annotations

import collections

import numpy as np


class _InFlight:
    __slots__ = ("timestamp", "delay", "value")

    def __init__(self, timestamp, delay, value):
        self.timestamp = timestamp
        self.delay = delay
        self.value = value

    @property
    def arrival(self):
        return self.timestamp + self.delay


class Buffer:
    """Stores (timestamp, delay, value) and serves arrived values."""

    def __init__(self, buffer_size, shape, dtype, pad_value=0.0,
                 strip_singleton_buffer_dim=False):
        self._buffer_size = buffer_size
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self._has_buffer_dim = not (strip_singleton_buffer_dim
                                    and buffer_size == 1)
        self._buffered_shape = ((buffer_size,) + shape
                                if self._has_buffer_dim else shape)
        self._dtype = dtype
        # exactly buffer_size delivered slots, oldest first; starts padded
        self._arrived = collections.deque(maxlen=buffer_size)
        for _ in range(buffer_size):
            self._arrived.append(_InFlight(
                -np.inf, 0, np.full(shape, pad_value, dtype)))
        # future deliveries, ordered by arrival time
        self._pending = collections.deque()

    @property
    def shape(self):
        return self._buffered_shape

    @property
    def has_buffer_dim(self):
        return self._has_buffer_dim

    @property
    def dtype(self):
        return self._dtype

    def _deliver_until(self, timestamp):
        while self._pending and self._pending[0].arrival <= timestamp:
            self._arrived.append(self._pending.popleft())

    def insert(self, timestamp, delay, value):
        """Adds an observation made at ``timestamp`` arriving after
        ``delay``; advances the buffer clock to ``timestamp``."""
        self._deliver_until(timestamp)
        obs = _InFlight(timestamp, delay, np.array(value))
        if delay == 0:
            self._arrived.append(obs)
        elif delay > 0:
            if not self._pending or obs.arrival >= self._pending[-1].arrival:
                self._pending.append(obs)
            else:
                # out-of-order arrival: keep pending sorted by arrival,
                # stably after any equal-arrival entries
                tail = collections.deque()
                while self._pending and obs.arrival < self._pending[-1].arrival:
                    tail.appendleft(self._pending.pop())
                self._pending.append(obs)
                self._pending.extend(tail)
        else:
            raise ValueError(f"delay must be non-negative, got {delay!r}")

    def read(self, current_time):
        """The buffer contents as delivered by ``current_time``."""
        self._deliver_until(current_time)
        if self._has_buffer_dim:
            out = np.empty(self._buffered_shape, dtype=self._dtype)
            for i, obs in enumerate(self._arrived):
                out[i] = obs.value
            return out
        return self._arrived[0].value.copy()

    def drop_unobserved_upcoming_items(self, observation_schedule,
                                       read_interval):
        """Removes planned ``(timestamp, delay)`` captures that can never
        be observed: reads happen at integer multiples of
        ``read_interval``, and an entry pushed out of the arrived window
        before the first read after its arrival is dead weight
        (reference obs_buffer.py:111-199)."""
        future_pending = collections.deque()
        future_arrived = collections.deque()

        # merge existing pending items with the proposed schedule, ordered
        # by arrival (existing entries are interleaved where they fall)
        def existing_iter():
            for obs in reversed(self._pending):
                yield _InFlight(obs.timestamp, obs.delay, None)
            while True:
                yield _InFlight(-np.inf, 0, None)

        existing = existing_iter()
        cur = next(existing)
        proposed = sorted(
            (_InFlight(t, d, None) for t, d in observation_schedule),
            key=lambda o: o.arrival)
        for new in reversed(proposed):
            while cur.arrival > new.arrival:
                future_pending.appendleft(cur)
                cur = next(existing)
            future_pending.appendleft(new)

        first_proposed = min(t for t, _ in observation_schedule)
        next_read = read_interval * int(np.ceil(
            first_proposed // read_interval))

        while future_pending:
            newly_arrived = collections.deque()
            while (future_pending
                   and future_pending[0].arrival <= next_read):
                obs = future_pending.popleft()
                future_arrived.append(obs)
                newly_arrived.append(obs)
            while len(future_arrived) > self._buffer_size:
                stale = future_arrived.popleft()
                if newly_arrived and stale is newly_arrived[0]:
                    newly_arrived.popleft()
                    # never delivered to any read: drop from the schedule
                    if stale.timestamp >= first_proposed:
                        observation_schedule.remove(
                            (stale.timestamp, stale.delay))
            next_read += read_interval
