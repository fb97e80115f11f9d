"""The control suite, batched on PyTorch.

All 19 of the JAX package's domains are ported (``DOMAINS``), its 51
tasks.
"""

from __future__ import annotations

import torch

from dm_control_torch.suite import (
    acrobot, ball_in_cup, cartpole, cheetah, dog, finger, fish, hopper,
    humanoid, humanoid_CMU, lqr, manipulator, pendulum, point_mass,
    quadruped, reacher, stacker, swimmer, walker,
)
from dm_control_torch.suite import base

DOMAINS = {
    "acrobot": acrobot, "ball_in_cup": ball_in_cup, "cartpole": cartpole,
    "cheetah": cheetah, "dog": dog, "finger": finger, "fish": fish,
    "hopper": hopper, "humanoid": humanoid, "humanoid_CMU": humanoid_CMU,
    "lqr": lqr, "manipulator": manipulator, "pendulum": pendulum,
    "point_mass": point_mass, "quadruped": quadruped, "reacher": reacher,
    "stacker": stacker, "swimmer": swimmer, "walker": walker,
}
#: every (domain, task) the port serves
ALL_TASKS = tuple((d, t) for d in sorted(DOMAINS) for t in DOMAINS[d].TASKS)


def load_batch(domain_name, task_name, *, device="cuda",
               dtype: torch.dtype, autoreset=True, task_kwargs=None,
               contact_cap=None):
    """A ``BatchEnv`` for a suite task, with its model on ``device`` in
    ``dtype``.  The device is the card unless the caller asks for another
    (``device="cpu"``): every tensor of the model and of the batch lives
    there.  Without CUDA the default raises.  ``task_kwargs`` go to the
    task's constructor (lqr's ``random``: the seed of its model);
    ``contact_cap`` to ``BatchEnv``."""
    from dm_control_torch.rl.batch_env import BatchEnv

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"load_batch({domain_name!r}, {task_name!r}): device "
            f"{str(device)!r} but CUDA is not available; pass device='cpu' "
            f"to run on the CPU")

    if domain_name not in DOMAINS:
        raise ValueError(f"Domain {domain_name!r} does not exist.")
    domain = DOMAINS[domain_name]
    if task_name not in domain.TASKS:
        raise ValueError(
            f"Level {task_name!r} does not exist in domain {domain_name!r}.")
    asset, task, *edit = domain.TASKS[task_name](**(task_kwargs or {}))
    return BatchEnv(base.load_model(asset, device, dtype, *edit), task,
                    time_limit=domain.TIME_LIMIT,
                    control_timestep=domain.CONTROL_TIMESTEP,
                    autoreset=autoreset, contact_cap=contact_cap)
