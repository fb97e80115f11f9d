"""Observation updater: schedules observable captures across substeps
(counterpart of ``dm_control_tpu/composer/observation/updater.py``).

Reference: dm_control/composer/observation/updater.py:119-317.  Faithful
semantics: ``prepare_for_next_control_step`` plans each observable's
capture times for the upcoming control period (evaluating callable
update_interval/delay at PLANNING time) and prunes captures that can
never be observed; ``update`` runs once per physics substep and executes
at most one scheduled capture per observable; ``get_observation`` reads
the ring buffers at the current step counter and applies aggregators.
"""

from __future__ import annotations

import collections

import numpy as np

from dm_control_torch.composer.observation.obs_buffer import Buffer
from dm_control_torch.rl import specs

DEFAULT_UPDATE_INTERVAL = 1
DEFAULT_DELAY = 0


def _call_if_callable(x, random_state=None):
    if callable(x):
        try:
            return x(random_state)
        except TypeError:
            return x()
    return x


class _ObservableState:
    __slots__ = ("observable", "buffer", "update_schedule",
                 "update_interval", "delay", "buffer_size")

    def __init__(self, observable, buffer):
        self.observable = observable
        self.buffer = buffer
        self.update_schedule = collections.deque()
        self.update_interval = (observable.update_interval
                                or DEFAULT_UPDATE_INTERVAL)
        self.delay = observable.delay or DEFAULT_DELAY
        self.buffer_size = observable.buffer_size or 1


class Updater:
    """Drives enabled observables over the substep loop."""

    def __init__(self, observables, physics_steps_per_control_step=1,
                 strip_singleton_buffer_dim=False):
        self._observables = collections.OrderedDict(observables)
        self._n_sub = physics_steps_per_control_step
        self._strip = strip_singleton_buffer_dim
        self._states = None
        self._step_counter = 0

    def reset(self, physics, random_state):
        self._step_counter = 0
        self._states = collections.OrderedDict()
        for name, obs in self._observables.items():
            if not obs.enabled:
                continue
            value = np.asarray(obs(physics, random_state))
            state = _ObservableState(obs, Buffer(
                obs.buffer_size or 1, value.shape, value.dtype,
                strip_singleton_buffer_dim=(self._strip
                                            and obs.buffer_size is None)))
            # the reset observation is subject to the observable's delay:
            # with a delay the first reads serve pad values (reference
            # updater.py:158-162)
            first_delay = _call_if_callable(state.delay, random_state)
            state.buffer.insert(0, first_delay, value)
            self._states[name] = state
        self._physics = physics
        self._random_state = random_state

    def prepare_for_next_control_step(self):
        """Plans capture times for the upcoming control period
        (reference updater.py:240-268)."""
        for state in self._states.values():
            if (state.update_interval == DEFAULT_UPDATE_INTERVAL
                    and state.delay == DEFAULT_DELAY
                    and state.buffer_size < self._n_sub):
                # common case: only the last buffer_size substeps matter
                for i in reversed(range(state.buffer_size)):
                    state.update_schedule.append(
                        (self._step_counter + self._n_sub - i,
                         DEFAULT_DELAY))
            else:
                if state.update_schedule:
                    last = state.update_schedule[-1][0]
                else:
                    last = self._step_counter
                max_step = self._step_counter + 2 * self._n_sub
                while last < max_step:
                    interval = _call_if_callable(state.update_interval,
                                                 self._random_state)
                    delay = _call_if_callable(state.delay,
                                              self._random_state)
                    last = last + interval
                    state.update_schedule.append((last, delay))
                state.buffer.drop_unobserved_upcoming_items(
                    state.update_schedule, self._n_sub)

    def update(self, physics=None, random_state=None):
        """Called once per physics substep: executes due captures."""
        physics = physics if physics is not None else self._physics
        random_state = (random_state if random_state is not None
                        else self._random_state)
        self._step_counter += 1
        for state in self._states.values():
            if (state.update_schedule
                    and state.update_schedule[0][0] == self._step_counter):
                timestamp, delay = state.update_schedule.popleft()
                value = state.observable(physics, random_state)
                state.buffer.insert(timestamp, delay, np.asarray(value))

    def get_observation(self):
        out = collections.OrderedDict()
        for name, state in self._states.items():
            values = state.buffer.read(self._step_counter)
            agg = state.observable.aggregator
            if agg is not None:
                value = agg(values)
            elif state.observable.buffer_size is None:
                # implicit size-1 buffers are served without the leading
                # buffer dim (the reference's strip_singleton_obs_buffer_dim
                # behavior, which this framework defaults to); if the
                # Buffer already stripped it, values is the bare value
                value = (values[-1] if state.buffer.has_buffer_dim
                         else values)
            else:
                value = values
            out[name] = value
        return out

    def observation_spec(self):
        out = collections.OrderedDict()
        sample = self.get_observation()
        for name in self._states:
            out[name] = specs.Array(shape=np.asarray(sample[name]).shape,
                                    dtype=np.asarray(sample[name]).dtype,
                                    name=name)
        return out
