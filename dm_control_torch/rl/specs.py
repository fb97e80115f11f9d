"""Array specs of observations and actions: the port's own copy of
``dm_env.specs.Array`` and ``BoundedArray``, with the same fields,
comparisons, validation and messages (the machines the port runs on need
not have ``dm_env``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

_INVALID_SHAPE = "Expected shape %r but found %r"
_INVALID_DTYPE = "Expected dtype %r but found %r"
_OUT_OF_BOUNDS = "Values were not all within bounds %s <= %s <= %s"
_MINIMUM_MUST_BE_LESS_THAN_OR_EQUAL_TO_MAXIMUM = (
    "All values in `minimum` must be less than or equal to their "
    "corresponding value in `maximum`, got:\nminimum={minimum!r}\n"
    "maximum={maximum!r}.")
_MINIMUM_INCOMPATIBLE_WITH_SHAPE = "`minimum` is incompatible with `shape`"
_MAXIMUM_INCOMPATIBLE_WITH_SHAPE = "`maximum` is incompatible with `shape`"


class Array:
    """The shape and dtype of a numpy array or scalar."""

    __slots__ = ("_shape", "_dtype", "_name")
    __hash__ = None

    def __init__(self, shape, dtype, name: Optional[str] = None):
        self._shape = tuple(int(dim) for dim in shape)
        self._dtype = np.dtype(dtype)
        self._name = name

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def name(self):
        return self._name

    def __repr__(self):
        return (f"Array(shape={self.shape}, dtype={self.dtype!r}, "
                f"name={self.name!r})")

    def __eq__(self, other):
        """Shape and dtype are equal (the name is not compared)."""
        if not isinstance(other, Array):
            return False
        return self.shape == other.shape and self.dtype == other.dtype

    def __ne__(self, other):
        return not self == other

    def _fail_validation(self, message, *args):
        message %= args
        if self.name:
            message += f" for spec {self.name}"
        raise ValueError(message)

    def validate(self, value):
        """``value`` as a numpy array; raises ValueError where its shape or
        dtype differs from the spec's."""
        value = np.asarray(value)
        if value.shape != self.shape:
            self._fail_validation(_INVALID_SHAPE, self.shape, value.shape)
        if value.dtype != self.dtype:
            self._fail_validation(_INVALID_DTYPE, self.dtype, value.dtype)
        return value

    def generate_value(self):
        """Zeros that conform to the spec."""
        return np.zeros(shape=self.shape, dtype=self.dtype)

    def _constructor_kwargs(self):
        return dict(shape=self.shape, dtype=self.dtype, name=self.name)

    def replace(self, **kwargs):
        """A copy with the given constructor arguments replaced."""
        return type(self)(**dict(self._constructor_kwargs(), **kwargs))

    def __reduce__(self):
        return Array, (self._shape, self._dtype, self._name)


class BoundedArray(Array):
    """An ``Array`` whose values lie within inclusive bounds (numbers or
    arrays that broadcast to the shape; either may be infinite)."""

    __slots__ = ("_minimum", "_maximum")
    __hash__ = None

    def __init__(self, shape, dtype, minimum, maximum, name=None):
        super().__init__(shape, dtype, name)
        try:
            bcast_minimum = np.broadcast_to(minimum, shape=shape)
        except ValueError as e:
            raise ValueError(_MINIMUM_INCOMPATIBLE_WITH_SHAPE) from e
        try:
            bcast_maximum = np.broadcast_to(maximum, shape=shape)
        except ValueError as e:
            raise ValueError(_MAXIMUM_INCOMPATIBLE_WITH_SHAPE) from e
        if np.any(bcast_minimum > bcast_maximum):
            raise ValueError(
                _MINIMUM_MUST_BE_LESS_THAN_OR_EQUAL_TO_MAXIMUM.format(
                    minimum=minimum, maximum=maximum))
        self._minimum = np.array(minimum, dtype=self.dtype)
        self._minimum.setflags(write=False)
        self._maximum = np.array(maximum, dtype=self.dtype)
        self._maximum.setflags(write=False)

    @property
    def minimum(self):
        return self._minimum

    @property
    def maximum(self):
        return self._maximum

    def __repr__(self):
        return (f"BoundedArray(shape={self.shape}, dtype={self.dtype!r}, "
                f"name={self.name!r}, minimum={self._minimum}, "
                f"maximum={self._maximum})")

    def __eq__(self, other):
        if not isinstance(other, BoundedArray):
            return False
        return (super().__eq__(other)
                and (self.minimum == other.minimum).all()
                and (self.maximum == other.maximum).all())

    def validate(self, value):
        value = np.asarray(value)
        super().validate(value)
        if (value < self.minimum).any() or (value > self.maximum).any():
            self._fail_validation(_OUT_OF_BOUNDS, self.minimum, value,
                                  self.maximum)
        return value

    def generate_value(self):
        """The minimum, at the spec's shape and dtype."""
        return (np.ones(shape=self.shape, dtype=self.dtype)
                * self.dtype.type(self.minimum))

    def _constructor_kwargs(self):
        return dict(super()._constructor_kwargs(), minimum=self.minimum,
                    maximum=self.maximum)

    def __reduce__(self):
        return BoundedArray, (self._shape, self._dtype, self._minimum,
                              self._maximum, self._name)
