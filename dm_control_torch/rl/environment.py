"""The dm_env interface, the port's own copy: ``StepType``, ``TimeStep``
and the abstract ``Environment``, with the fields, values and defaults
of ``dm_env``'s (the machines the port runs on need not have
``dm_env``)."""

from __future__ import annotations

import abc
import enum
from typing import Any, NamedTuple

from dm_control_torch.rl import specs


class StepType(enum.IntEnum):
    """Where a ``TimeStep`` stands in its episode."""

    FIRST = 0
    MID = 1
    LAST = 2

    def first(self) -> bool:
        return self is StepType.FIRST

    def mid(self) -> bool:
        return self is StepType.MID

    def last(self) -> bool:
        return self is StepType.LAST


class TimeStep(NamedTuple):
    """What ``reset`` and ``step`` return.  ``reward`` and ``discount`` are
    None on the FIRST step of an episode."""

    step_type: Any
    reward: Any
    discount: Any
    observation: Any

    def first(self) -> bool:
        return self.step_type == StepType.FIRST

    def mid(self) -> bool:
        return self.step_type == StepType.MID

    def last(self) -> bool:
        return self.step_type == StepType.LAST


class Environment(metaclass=abc.ABCMeta):
    """Abstract reinforcement-learning environment (``dm_env.Environment``):
    observations and actions are described by ``specs.Array``s."""

    @abc.abstractmethod
    def reset(self) -> TimeStep:
        """Starts an episode; returns its FIRST ``TimeStep``."""

    @abc.abstractmethod
    def step(self, action) -> TimeStep:
        """Applies ``action``; after a LAST step (or before any reset) it
        starts a new episode and ignores ``action``."""

    def reward_spec(self):
        return specs.Array(shape=(), dtype=float, name="reward")

    def discount_spec(self):
        return specs.BoundedArray(shape=(), dtype=float, minimum=0.,
                                  maximum=1., name="discount")

    @abc.abstractmethod
    def observation_spec(self):
        """The spec of each observation."""

    @abc.abstractmethod
    def action_spec(self):
        """The spec of the actions ``step`` takes."""

    def close(self):
        """Frees what the environment holds (nothing by default)."""

    def __enter__(self):
        return self

    def __exit__(self, unused_exception_type, unused_exc_value,
                 unused_traceback):
        self.close()
