"""Variation base: composable random-value DSL
(reference: dm_control/composer/variation/base.py:25-116 and
variation_values.py:21).

Counterpart of ``dm_control_tpu/composer/variation/base.py``.
"""

from __future__ import annotations

import abc
import operator

import numpy as np


def evaluate(value, initial_value=None, current_value=None,
             random_state=None):
    """Resolves a value or Variation into a concrete value."""
    if isinstance(value, Variation):
        return value(initial_value=initial_value,
                     current_value=current_value,
                     random_state=random_state or np.random)
    if isinstance(value, (list, tuple)):
        return type(value)(
            evaluate(v, initial_value, current_value, random_state)
            for v in value)
    return value


class Variation(abc.ABC):
    """A value sampled per evaluation, supporting arithmetic composition."""

    @abc.abstractmethod
    def __call__(self, initial_value, current_value, random_state):
        raise NotImplementedError

    def __add__(self, other):
        return _BinaryOperation(operator.add, self, other)

    def __radd__(self, other):
        return _BinaryOperation(operator.add, other, self)

    def __sub__(self, other):
        return _BinaryOperation(operator.sub, self, other)

    def __rsub__(self, other):
        return _BinaryOperation(operator.sub, other, self)

    def __mul__(self, other):
        return _BinaryOperation(operator.mul, self, other)

    def __rmul__(self, other):
        return _BinaryOperation(operator.mul, other, self)

    def __truediv__(self, other):
        return _BinaryOperation(operator.truediv, self, other)

    def __rtruediv__(self, other):
        return _BinaryOperation(operator.truediv, other, self)

    def __neg__(self):
        return _UnaryOperation(operator.neg, self)


class _UnaryOperation(Variation):
    def __init__(self, op, value):
        self._op = op
        self._value = value

    def __call__(self, initial_value, current_value, random_state):
        return self._op(evaluate(self._value, initial_value, current_value,
                                 random_state))


class _BinaryOperation(Variation):
    def __init__(self, op, left, right):
        self._op = op
        self._left = left
        self._right = right

    def __call__(self, initial_value, current_value, random_state):
        return self._op(
            evaluate(self._left, initial_value, current_value, random_state),
            evaluate(self._right, initial_value, current_value,
                     random_state))
