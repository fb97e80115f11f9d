"""Distribution variations
(reference: dm_control/composer/variation/distributions.py:75-186).

Counterpart of ``dm_control_tpu/composer/variation/distributions.py``.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.composer.variation.base import Variation, evaluate


class Distribution(Variation):
    """Wraps a np.random distribution with lazily-evaluated args."""

    __slots__ = ("_args", "_kwargs", "_single_sample")
    _distribution_name = None

    def __init__(self, *args, single_sample=False, **kwargs):
        self._args = args
        self._kwargs = kwargs
        self._single_sample = single_sample

    def __call__(self, initial_value=None, current_value=None,
                 random_state=None):
        random_state = random_state or np.random
        size = (None if self._single_sample or np.isscalar(current_value)
                else np.shape(current_value) or None)
        args = evaluate(self._args, initial_value, current_value,
                        random_state)
        kwargs = evaluate(self._kwargs, initial_value, current_value,
                          random_state)
        return getattr(random_state, self._distribution_name)(
            *args, size=size, **kwargs)


class Uniform(Distribution):
    _distribution_name = "uniform"

    def __init__(self, low=0.0, high=1.0, single_sample=False):
        super().__init__(low, high, single_sample=single_sample)


class UniformInteger(Distribution):
    _distribution_name = "randint"

    def __init__(self, low, high=None, single_sample=False):
        super().__init__(low, high, single_sample=single_sample)


class UniformChoice(Distribution):
    _distribution_name = "choice"

    def __init__(self, choices, single_sample=False):
        super().__init__(choices, single_sample=single_sample)


class UniformPointOnSphere(Variation):
    """Uniformly distributed unit vectors."""

    def __call__(self, initial_value=None, current_value=None,
                 random_state=None):
        random_state = random_state or np.random
        axis = random_state.normal(size=3)
        return axis / np.linalg.norm(axis)


class Normal(Distribution):
    _distribution_name = "normal"

    def __init__(self, loc=0.0, scale=1.0, single_sample=False):
        super().__init__(loc, scale, single_sample=single_sample)


class LogNormal(Distribution):
    _distribution_name = "lognormal"

    def __init__(self, mean=0.0, sigma=1.0, single_sample=False):
        super().__init__(mean, sigma, single_sample=single_sample)


class Exponential(Distribution):
    _distribution_name = "exponential"

    def __init__(self, scale=1.0, single_sample=False):
        super().__init__(scale, single_sample=single_sample)


class Poisson(Distribution):
    _distribution_name = "poisson"

    def __init__(self, lam=1.0, single_sample=False):
        super().__init__(lam, single_sample=single_sample)


class Bernoulli(Distribution):
    _distribution_name = "binomial"

    def __init__(self, prob=0.5, single_sample=False):
        super().__init__(1, prob, single_sample=single_sample)
