"""Duplo snap-fit measurement (counterpart of
``dm_control_tpu/entities/props/duplo/utils.py``; reference:
dm_control/entities/props/duplo/utils.py:24-91).

Used by the tests and by ``autotune.py`` to measure the force that pulls
two engaged bricks apart, on the port's ``Physics`` (one environment).
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_torch import composer
from dm_control_torch.entities.props.duplo import BRICK_HEIGHT
from dm_control_torch.physics.physics import Physics


def stack_bricks(top_brick, bottom_brick):
    """Stacks two bricks: bottom fixed to the arena, top free, engaged
    one brick-height above.  Returns (arena, top attachment frame)."""
    arena = composer.Arena()
    arena.attach(bottom_brick)
    frame = arena.add_free_entity(top_brick)
    frame.attrib["pos"] = f"0 0 {BRICK_HEIGHT}"
    return arena, frame


def separation_physics(top_brick, bottom_brick, *, device=None,
                       dtype=torch.float64):
    """The stacked pair without gravity on ``device`` (the card unless the
    caller asks for another), and the top brick's frame: what
    ``measure_separation_force`` probes."""
    arena, frame = stack_bricks(top_brick, bottom_brick)
    root = arena.mjcf_model
    option = root.first("option") or root.add("option")
    option.attrib["gravity"] = "0 0 0"
    return Physics.from_mjcf_model(root, device=device, dtype=dtype), frame


def separates(physics, binding, force, n_steps, height_threshold=1e-3,
              heights=None):
    """Whether the vertical ``force`` (N) on the top brick lifts it by more
    than ``height_threshold`` within ``n_steps`` steps from the reset
    state; ``heights``, where given, collects the brick's heights as the
    probe reads them: at the reset, then after each step."""
    physics.reset()
    initial_height = float(binding.xpos[2])
    if heights is not None:
        heights.append(initial_height)
    wrench = np.zeros(6)
    wrench[2] = force
    binding.xfrc_applied = wrench
    for _ in range(n_steps):
        physics.step()
        height = float(binding.xpos[2])
        if heights is not None:
            heights.append(height)
        if height - initial_height > height_threshold:
            return True
    return False


def measure_separation_force(top_brick, bottom_brick, min_force=0.0,
                             max_force=20.0, tolerance=0.01,
                             time_limit=0.5, height_threshold=1e-3, *,
                             device=None, dtype=torch.float64):
    """Bisects for the vertical force (N) that separates the bricks.

    Gravity is disabled so the measurement reads pure snap strength;
    because the contact model is soft, a longer ``time_limit`` lets the
    bricks creep apart under smaller forces, giving lower estimates.
    Every probe steps the pair on ``device`` (the card unless the caller
    asks for another) and reads the brick's height on the host each step,
    as the JAX package's does."""
    physics, frame = separation_physics(top_brick, bottom_brick,
                                        device=device, dtype=dtype)
    binding = physics.bind(frame)
    n_steps = int(round(time_limit / float(physics.model.opt.timestep)))

    def probe(force):
        return separates(physics, binding, force, n_steps, height_threshold)

    while min_force > 0 and probe(min_force):
        min_force *= 0.5
    while not probe(max_force):
        max_force *= 2.0
        if max_force > 1e4:
            raise RuntimeError("bricks never separate: bad geometry?")

    lo, hi = min_force, max_force
    while hi - lo > tolerance:
        mid = 0.5 * (lo + hi)
        if probe(mid):
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)
