"""Noise variations (reference: dm_control/composer/variation/noises.py).

Counterpart of ``dm_control_tpu/composer/variation/noises.py``.
"""

from __future__ import annotations

from dm_control_torch.composer.variation.base import Variation, evaluate


class Additive(Variation):
    """current + noise (or initial + noise with cumulative=False semantics
    per reference noises.py:23)."""

    def __init__(self, noise, cumulative=False):
        self._noise = noise
        self._cumulative = cumulative

    def __call__(self, initial_value=None, current_value=None,
                 random_state=None):
        amount = evaluate(self._noise, initial_value, current_value,
                          random_state)
        base = current_value if self._cumulative else initial_value
        return base + amount


class Multiplicative(Variation):
    """base * noise (reference noises.py:43)."""

    def __init__(self, noise, cumulative=False):
        self._noise = noise
        self._cumulative = cumulative

    def __call__(self, initial_value=None, current_value=None,
                 random_state=None):
        amount = evaluate(self._noise, initial_value, current_value,
                          random_state)
        base = current_value if self._cumulative else initial_value
        return base * amount
