"""Lowering composer tasks onto the batched path.

Counterpart of ``dm_control_tpu/composer/batch.py``.  A composer task that
implements the ``BatchableTask`` protocol (its episode init, observation
and reward as functions of a batched (Model, Data), B first) becomes an
``rl.control.Task`` and is stepped by ``rl.batch_env.BatchEnv``: thousands
of environments in lockstep on one device.

Per-episode randomization is data, not recompilation: model overrides
through the ``model_diff`` dict (a resampled target site position
overrides ``site_pos``), and task-private per-environment state through
"_"-prefixed diff keys, which the task reads as ``m.task_state``
(``rl/control.py::apply_model_diff``).

Every task is compiled from its entity tree, as the JAX package's
``compile_task`` and the host ``composer.Environment`` compile it: the
root entity's MJCF with ``option/timestep`` set to the task's physics
timestep, through ``mjcf.compile_model``.
"""

from __future__ import annotations

import torch

from dm_control_torch.composer.environment import set_timestep
from dm_control_torch.mjcf.compiler import compile_model
from dm_control_torch.rl import control
from dm_control_torch.rl.batch_env import BatchEnv
from dm_control_torch.suite import check_device


class BatchableTask:
    """Protocol mixin for composer tasks that run on the batched path.

    A task is a composer ``Task`` (it has a ``root_entity``); it sets
    ``control_timestep`` and ``physics_timestep``, and implements the
    ``batch_*`` hooks over batched tensors: ``qpos`` (B, nq), a Data of B
    environments, draws of ``rl.control.RandomContext`` with B first.
    A task that leaves ``batch_observation`` or ``batch_reward``
    unimplemented does not run on the batched path.
    """

    control_timestep: float = 0.0
    physics_timestep: float = 0.0
    #: physics steps to settle after init
    batch_settle_steps: int = 0
    #: shape of batch_reward's per-environment value: () for a scalar,
    #: (n_players,) for one reward per player (soccer)
    batch_reward_shape: tuple = ()
    #: re-draw episodes while batch_reject holds, at most this many times
    batch_max_reset_rejections: int = 0

    def batch_model_diff(self, m):
        """Structure (with defaults) of the per-episode model_diff."""
        return {}

    def batch_init(self, m, qpos, qvel, rc, diff):
        """Episode init: returns (qpos, qvel, diff), B first."""
        return qpos, qvel, diff

    def batch_reject(self, m, d):
        return torch.zeros(d.qpos.shape[0], dtype=torch.bool,
                           device=d.qpos.device)

    def batch_observation(self, m, d):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the batched path")

    def batch_reward(self, m, d):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the batched path")

    def batch_termination(self, m, d):
        B = d.qpos.shape[0]
        return (torch.zeros(B, dtype=torch.bool, device=d.qpos.device),
                torch.ones(B, dtype=d.qpos.dtype, device=d.qpos.device))


class _PureTaskAdapter(control.Task):
    """Wraps a BatchableTask composer task as an ``rl.control.Task``."""

    def __init__(self, ctask: BatchableTask):
        self._t = ctask
        self.settle_steps = ctask.batch_settle_steps
        self.reward_shape = tuple(ctask.batch_reward_shape)
        self.max_reset_rejections = ctask.batch_max_reset_rejections

    def initial_model_diff(self, m):
        return self._t.batch_model_diff(m)

    def init(self, m, qpos, qvel, rc, diff):
        return self._t.batch_init(m, qpos, qvel, rc, diff)

    def reject(self, m, d):
        return self._t.batch_reject(m, d)

    def observation(self, m, d):
        return self._t.batch_observation(m, d)

    def reward(self, m, d):
        return self._t.batch_reward(m, d)

    def termination(self, m, d):
        return self._t.batch_termination(m, d)


def implements_batch(task) -> bool:
    """Whether ``task`` runs on the batched path: a ``BatchableTask`` with
    its own ``batch_observation`` and ``batch_reward``."""
    cls = type(task)
    return (isinstance(task, BatchableTask)
            and cls.batch_observation is not BatchableTask.batch_observation
            and cls.batch_reward is not BatchableTask.batch_reward)


def task_model(task, device, dtype: torch.dtype):
    """The compiled model of a task on ``device`` in ``dtype``: its root
    entity's tree compiled with the task's physics timestep."""
    root = task.root_entity.mjcf_model
    set_timestep(root, task.physics_timestep)
    return compile_model(root, device=device, dtype=dtype)


def compile_task(task, *, device="cuda", dtype: torch.dtype,
                 time_limit=10.0, autoreset=True,
                 contact_cap=None) -> BatchEnv:
    """A ``BatchEnv`` of a composer task: its compiled model
    (``task_model``) on ``device`` in ``dtype``, stepped at the task's
    control timestep.  The device is the card unless the caller asks for
    another (``device="cpu"``); without CUDA the default raises.  ``task``
    must implement ``BatchableTask`` (``implements_batch``), else
    ``TypeError``; ``contact_cap`` goes to ``BatchEnv``."""
    if not implements_batch(task):
        raise TypeError(
            f"{type(task).__name__} does not implement BatchableTask")
    check_device(f"compile_task({type(task).__name__})", device)
    model = task_model(task, device, dtype)
    return BatchEnv(model, _PureTaskAdapter(task), time_limit=time_limit,
                    control_timestep=task.control_timestep,
                    autoreset=autoreset, contact_cap=contact_cap)
