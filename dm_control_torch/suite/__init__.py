"""The control suite, batched on PyTorch.

Only humanoid is ported so far; ``load_batch`` raises for every other
domain (ROADMAP A lists what is still to port).
"""

from __future__ import annotations

import torch

from dm_control_torch.suite import humanoid

_DOMAINS = {"humanoid": humanoid}


def load_batch(domain_name, task_name, *, device, dtype: torch.dtype,
               autoreset=True):
    """A ``BatchEnv`` for a suite task, with its model on ``device`` in
    ``dtype``.  There is no default device: on a CUDA device every tensor
    of the model and of the batch lives on the card."""
    from dm_control_torch.rl.batch_env import BatchEnv

    if domain_name not in _DOMAINS:
        raise NotImplementedError(
            f"domain {domain_name!r} is not ported yet (ROADMAP A: the "
            f"other 18 domains); ported: {sorted(_DOMAINS)}")
    domain = _DOMAINS[domain_name]
    if task_name not in domain.TASKS:
        raise ValueError(
            f"Level {task_name!r} does not exist in domain {domain_name!r}.")
    move_speed, pure_state = domain.TASKS[task_name]
    model = domain.get_model(device, dtype)
    return BatchEnv(model, domain.Humanoid(move_speed, pure_state),
                    time_limit=domain.TIME_LIMIT,
                    control_timestep=domain.CONTROL_TIMESTEP,
                    autoreset=autoreset)
