"""The control suite, batched on PyTorch.

Sixteen of the JAX package's 19 domains are ported (``DOMAINS``), 41 of
its 51 tasks; ``load_batch`` raises ``NotImplementedError`` naming the
ROADMAP item for each of the others.
"""

from __future__ import annotations

import torch

from dm_control_torch.suite import (
    acrobot, ball_in_cup, cartpole, cheetah, finger, fish, hopper, humanoid,
    manipulator, pendulum, point_mass, quadruped, reacher, stacker, swimmer,
    walker,
)
from dm_control_torch.suite import base

DOMAINS = {
    "acrobot": acrobot, "ball_in_cup": ball_in_cup, "cartpole": cartpole,
    "cheetah": cheetah, "finger": finger, "fish": fish, "hopper": hopper,
    "humanoid": humanoid, "manipulator": manipulator, "pendulum": pendulum,
    "point_mass": point_mass, "quadruped": quadruped, "reacher": reacher,
    "stacker": stacker, "swimmer": swimmer, "walker": walker,
}
#: every (domain, task) the port serves
ALL_TASKS = tuple((d, t) for d in sorted(DOMAINS) for t in DOMAINS[d].TASKS)

#: the JAX package's other domains -> the ROADMAP item that ports them
_NOT_PORTED = {
    "humanoid_CMU": "A3: humanoid_CMU, dog and lqr",
    "dog": "A3: humanoid_CMU, dog and lqr",
    "lqr": "A3: humanoid_CMU, dog and lqr",
}


def load_batch(domain_name, task_name, *, device, dtype: torch.dtype,
               autoreset=True):
    """A ``BatchEnv`` for a suite task, with its model on ``device`` in
    ``dtype``.  There is no default device: on a CUDA device every tensor
    of the model and of the batch lives on the card."""
    from dm_control_torch.rl.batch_env import BatchEnv

    if domain_name in _NOT_PORTED:
        raise NotImplementedError(
            f"domain {domain_name!r} is not ported yet (ROADMAP "
            f"{_NOT_PORTED[domain_name]}); ported: {sorted(DOMAINS)}")
    if domain_name not in DOMAINS:
        raise ValueError(f"Domain {domain_name!r} does not exist.")
    domain = DOMAINS[domain_name]
    if task_name not in domain.TASKS:
        raise ValueError(
            f"Level {task_name!r} does not exist in domain {domain_name!r}.")
    asset, task = domain.TASKS[task_name]()
    return BatchEnv(base.load_model(asset, device, dtype), task,
                    time_limit=domain.TIME_LIMIT,
                    control_timestep=domain.CONTROL_TIMESTEP,
                    autoreset=autoreset)
