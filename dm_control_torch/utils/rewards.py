"""Soft indicator ("tolerance") reward shaping on tensors.

Counterpart of ``dm_control_tpu/utils/rewards.py`` (reference
dm_control/utils/rewards.py:25-136): 1 inside the target interval,
falling off outside it through a chosen sigmoid.  A number in gives a
float out, computed in float64 (the composer tasks' host hooks).
"""

from __future__ import annotations

import math

import torch

_DEFAULT_VALUE_AT_MARGIN = 0.1


def _gaussian(x, value_at_margin):
    scale = math.sqrt(-2.0 * math.log(value_at_margin))
    return torch.exp(-0.5 * (x * scale) ** 2)


def _hyperbolic(x, value_at_margin):
    scale = math.acosh(1.0 / value_at_margin)
    return 1.0 / torch.cosh(x * scale)


def _long_tail(x, value_at_margin):
    scale = math.sqrt(1.0 / value_at_margin - 1.0)
    return 1.0 / ((x * scale) ** 2 + 1.0)


def _reciprocal(x, value_at_margin):
    scale = 1.0 / value_at_margin - 1.0
    return 1.0 / (torch.abs(x) * scale + 1.0)


def _cosine(x, value_at_margin):
    scale = math.acos(2.0 * value_at_margin - 1.0) / math.pi
    scaled = x * scale
    return torch.where(torch.abs(scaled) < 1.0,
                       (1.0 + torch.cos(math.pi * scaled)) / 2.0,
                       torch.zeros_like(scaled))


def _linear(x, value_at_margin):
    scaled = x * (1.0 - value_at_margin)
    return torch.where(torch.abs(scaled) < 1.0, 1.0 - torch.abs(scaled),
                       torch.zeros_like(scaled))


def _quadratic(x, value_at_margin):
    scaled = x * math.sqrt(1.0 - value_at_margin)
    return torch.where(torch.abs(scaled) < 1.0, 1.0 - scaled ** 2,
                       torch.zeros_like(scaled))


def _tanh_squared(x, value_at_margin):
    scale = math.atanh(math.sqrt(1.0 - value_at_margin))
    return 1.0 - torch.tanh(x * scale) ** 2


_SIGMOIDS = {
    "gaussian": _gaussian,
    "hyperbolic": _hyperbolic,
    "long_tail": _long_tail,
    "reciprocal": _reciprocal,
    "cosine": _cosine,
    "linear": _linear,
    "quadratic": _quadratic,
    "tanh_squared": _tanh_squared,
}


def sigmoid(x, value_at_1: float, sigmoid: str = "gaussian"):
    """Maps x monotonically to [0, 1] with sigmoid(0) = 1 and
    sigmoid(1) = value_at_1."""
    if sigmoid in ("cosine", "linear", "quadratic"):
        if not 0 <= value_at_1 < 1:
            raise ValueError(f"`value_at_1` must be nonnegative and smaller "
                             f"than 1, got {value_at_1}.")
    elif not 0 < value_at_1 < 1:
        raise ValueError(f"`value_at_1` must be strictly between 0 and 1, "
                         f"got {value_at_1}.")
    if sigmoid not in _SIGMOIDS:
        raise ValueError(f"Unknown sigmoid type {sigmoid!r}. "
                         f"Valid: {sorted(_SIGMOIDS)}.")
    return _SIGMOIDS[sigmoid](x, value_at_1)


def _number(v) -> bool:
    return isinstance(v, (int, float))


def tolerance(x: torch.Tensor, bounds=(0.0, 0.0), margin=0.0,
              sigmoid: str = "gaussian",
              value_at_margin: float = _DEFAULT_VALUE_AT_MARGIN):
    """1 where ``x`` is in ``bounds``, decaying to ``value_at_margin`` at
    ``margin`` outside them (``margin == 0``: a hard indicator).  A bound
    or the margin may be a tensor that broadcasts against ``x`` (one per
    environment); the checks of their values apply to numbers only.  A
    number ``x`` gives a float."""
    if _number(x):
        return float(tolerance(torch.tensor(float(x), dtype=torch.float64),
                               bounds, margin, sigmoid, value_at_margin))
    lower, upper = bounds
    if _number(lower) and _number(upper) and lower > upper:
        raise ValueError("Lower bound must be <= upper bound.")
    if _number(margin) and margin < 0:
        raise ValueError(f"`margin` must be non-negative, got {margin}.")
    in_bounds = (lower <= x) & (x <= upper)
    one = torch.ones_like(x)
    if _number(margin) and margin == 0:
        return torch.where(in_bounds, one, torch.zeros_like(x))
    d = torch.where(x < lower, lower - x, x - upper) / margin
    return torch.where(in_bounds, one, _SIGMOIDS[sigmoid](d, value_at_margin))
