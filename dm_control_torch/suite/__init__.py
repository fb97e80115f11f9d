"""The control suite on PyTorch: one environment with the dm_env
interface (``load``) or a batch of them (``load_batch``).

All 19 of the JAX package's domains are ported (``DOMAINS``), its 51
tasks, with its task sets (``BENCHMARKING``, ``EASY``, ``HARD``,
``EXTRA``).  Each task's model is compiled by the port's MJCF compiler
from the domain's literal tree (``suite/models/``) when the task is
loaded: literal → ``mjcf.compile_model`` → ``BatchEnv`` or
``Environment``.
"""

from __future__ import annotations

import collections
import inspect

import numpy as np
import torch

from dm_control_torch.rl.control import Environment
from dm_control_torch.suite import (
    acrobot, ball_in_cup, cartpole, cheetah, dog, finger, fish, hopper,
    humanoid, humanoid_CMU, lqr, manipulator, pendulum, point_mass,
    quadruped, reacher, stacker, swimmer, walker,
)

DOMAINS = {
    "acrobot": acrobot, "ball_in_cup": ball_in_cup, "cartpole": cartpole,
    "cheetah": cheetah, "dog": dog, "finger": finger, "fish": fish,
    "hopper": hopper, "humanoid": humanoid, "humanoid_CMU": humanoid_CMU,
    "lqr": lqr, "manipulator": manipulator, "pendulum": pendulum,
    "point_mass": point_mass, "quadruped": quadruped, "reacher": reacher,
    "stacker": stacker, "swimmer": swimmer, "walker": walker,
}


def _get_tasks(tag):
    return tuple((d, t) for d in sorted(DOMAINS)
                 for t in (DOMAINS[d].TASKS if tag is None
                           else DOMAINS[d].TASKS.tagged(tag)))


def _get_tasks_by_domain(tasks):
    result = collections.defaultdict(list)
    for domain_name, task_name in tasks:
        result[domain_name].append(task_name)
    return {k: tuple(v) for k, v in result.items()}


#: every (domain, task) the port serves
ALL_TASKS = _get_tasks(tag=None)
BENCHMARKING = _get_tasks("benchmarking")
EASY = _get_tasks("easy")
HARD = tuple(t for t in BENCHMARKING if t not in EASY)
EXTRA = tuple(t for t in ALL_TASKS if t not in BENCHMARKING)
TASKS_BY_DOMAIN = _get_tasks_by_domain(ALL_TASKS)
BENCHMARKING_BY_DOMAIN = _get_tasks_by_domain(BENCHMARKING)


def check_device(what, device):
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: device {str(device)!r} but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")


def _find_domain(domain_name, task_name):
    if domain_name not in DOMAINS:
        raise ValueError(f"Domain {domain_name!r} does not exist.")
    domain = DOMAINS[domain_name]
    if task_name not in domain.TASKS:
        raise ValueError(
            f"Level {task_name!r} does not exist in domain {domain_name!r}.")
    return domain


def load(domain_name, task_name, task_kwargs=None, environment_kwargs=None,
         visualize_reward=False, *, device="cuda",
         dtype: torch.dtype = torch.float64):
    """One environment of a suite task with the dm_env interface
    (``rl.control.Environment``), its model on ``device`` in ``dtype``.

    The device is the card unless the caller asks for another
    (``device="cpu"``); without CUDA the default raises.  The dtype is
    float64 by default: the single environment's contract is the
    reference's float64 numbers.  ``task_kwargs`` are the JAX package's:
    ``random`` (the seed or RandomState of the episodes, and of lqr's
    model), ``time_limit`` and the task's own (``fully_observable``,
    three_poles' ``num_poles`` and ``sparse``); ``environment_kwargs`` go
    to the ``Environment``.  ``visualize_reward`` is accepted and unused:
    rendering is not ported (ROADMAP A6)."""
    del visualize_reward
    return build_environment(domain_name, task_name, task_kwargs,
                             environment_kwargs, device=device, dtype=dtype)


def build_environment(domain_name, task_name, task_kwargs=None,
                      environment_kwargs=None, *, device="cuda",
                      dtype: torch.dtype = torch.float64):
    """The ``Environment`` of ``load`` (see there)."""
    domain = _find_domain(domain_name, task_name)
    check_device(f"load({domain_name!r}, {task_name!r})", device)
    factory = domain.TASKS[task_name]
    kwargs = dict(task_kwargs or {})
    if environment_kwargs is not None:
        kwargs["environment_kwargs"] = environment_kwargs
    time_limit = kwargs.pop("time_limit", domain.TIME_LIMIT)
    environment_kwargs = kwargs.pop("environment_kwargs", None) or {}
    random = kwargs.pop("random", None)
    if not isinstance(random, np.random.RandomState):
        random = np.random.RandomState(random)
    if "random" in inspect.signature(factory).parameters:
        kwargs["random"] = random  # lqr: the model draws from it first
    variant, task = factory(**kwargs)
    # a domain with its own control timestep passes it, as the JAX
    # domain's constructor does (environment_kwargs may not pass another)
    timestep = ({} if domain.CONTROL_TIMESTEP is None
                else {"control_timestep": domain.CONTROL_TIMESTEP})
    return Environment(variant.get_model(device, dtype), task,
                       time_limit=time_limit, random=random, **timestep,
                       **environment_kwargs)


def load_batch(domain_name, task_name, *, device="cuda",
               dtype: torch.dtype, autoreset=True, task_kwargs=None,
               contact_cap=None):
    """A ``BatchEnv`` for a suite task, with its model on ``device`` in
    ``dtype``.  The device is the card unless the caller asks for another
    (``device="cpu"``): every tensor of the model and of the batch lives
    there.  Without CUDA the default raises.  ``task_kwargs`` go to the
    task's constructor (lqr's ``random``: the seed of its model;
    three_poles' ``num_poles``: any number of poles);
    ``contact_cap`` to ``BatchEnv``."""
    from dm_control_torch.rl.batch_env import BatchEnv

    domain = _find_domain(domain_name, task_name)
    check_device(f"load_batch({domain_name!r}, {task_name!r})", device)
    variant, task = domain.TASKS[task_name](**(task_kwargs or {}))
    return BatchEnv(variant.get_model(device, dtype), task,
                    time_limit=domain.TIME_LIMIT,
                    control_timestep=domain.CONTROL_TIMESTEP,
                    autoreset=autoreset, contact_cap=contact_cap)
