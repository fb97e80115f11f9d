"""Parameter randomization DSL (counterpart of
``dm_control_tpu/composer/variation/``; reference:
dm_control/composer/variation/).  Every draw comes from the
``RandomState`` handed in (numpy's global state where none is), in the
JAX package's order.
"""

import torch

from dm_control_torch.composer.variation.base import Variation, evaluate  # noqa: F401
from dm_control_torch.composer.variation import distributions, noises  # noqa: F401


class MJCFVariator:
    """Applies per-episode variations to element attributes, remembering
    and restoring original values (reference variation/__init__.py:34).

    An attribute variation takes effect at the next compile of the tree;
    ``PhysicsVariator`` changes the compiled model instead.
    """

    def __init__(self):
        self._initial = {}

    def apply_variations(self, element, variations, random_state):
        for attr, variation in variations.items():
            key = (id(element), attr)
            if key not in self._initial:
                self._initial[key] = element.get(attr)
            initial = self._initial[key]
            element.attrib[attr] = evaluate(
                variation, initial_value=initial,
                current_value=element.get(attr), random_state=random_state)

    def reset_initial_values(self):
        self._initial.clear()


class PhysicsVariator:
    """Applies variations to model/data arrays each episode
    (reference variation/__init__.py:90): the physics' ``Model`` is
    replaced by one whose fields hold the drawn values, in the model's
    type on its device."""

    def __init__(self):
        self._initial = {}

    def apply_variations(self, physics, specs, random_state):
        """``specs``: list of (field, index, variation)."""
        model = physics.model
        updates = {}
        for field, index, variation in specs:
            arr = updates.get(
                field, getattr(model, field).detach().cpu().numpy().copy())
            key = (field, index)
            if key not in self._initial:
                self._initial[key] = arr[index]
            arr[index] = evaluate(
                variation, initial_value=self._initial[key],
                current_value=arr[index], random_state=random_state)
            updates[field] = arr
        if updates:
            physics._model = model.replace(
                **{k: torch.as_tensor(v, dtype=getattr(model, k).dtype,
                                      device=model.device)
                   for k, v in updates.items()})
