"""Props placed where they touch nothing, by drawing again (counterpart of
``dm_control_tpu/composer/initializers/prop_initializer.py``; reference:
dm_control/composer/initializers/prop_initializer.py:41)."""

from __future__ import annotations

import numpy as np

from dm_control_torch.composer.variation.base import evaluate


class PropPlacer:
    """Places free props at drawn poses, each drawn again while any contact
    of the model penetrates."""

    def __init__(self, props, position, quaternion=None,
                 ignore_collisions=False, max_attempts_per_prop=40,
                 settle_physics=False):
        self._props = props
        self._position = position
        self._quaternion = quaternion
        self._ignore_collisions = ignore_collisions
        self._max_attempts = max_attempts_per_prop
        self._settle = settle_physics

    def __call__(self, physics, random_state):
        """For each prop: a position, then a quaternion where one is given,
        from ``random_state``; the contacts of the pose are those of a
        position stage from the physics' present Data (the physics itself
        is not brought forward, as in the JAX package)."""
        from dm_control_torch.physics import engine

        for prop in self._props:
            placed = False
            for _ in range(self._max_attempts):
                pos = np.asarray(evaluate(
                    self._position, random_state=random_state))
                quat = (np.asarray(evaluate(
                    self._quaternion, random_state=random_state))
                    if self._quaternion is not None
                    else np.array([1.0, 0, 0, 0]))
                prop.set_pose(physics, pos, quat)
                if self._ignore_collisions:
                    placed = True
                    break
                d = engine.fwd_position(physics.model, physics._data)
                if not bool((d.contact.dist < 0).any()):
                    placed = True
                    break
            if not placed:
                raise RuntimeError(
                    f"Failed to place prop {prop.name!r} without collisions "
                    f"after {self._max_attempts} attempts.")
        if self._settle:
            physics.step(200)
