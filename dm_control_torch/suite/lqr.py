"""LQR domain, batched (reference: dm_control/suite/lqr.py).

A chain of masses on slide joints with motors; the reward is a quadratic
regulator cost.  The model depends on the seed: each joint's stiffness is
drawn U(15, 25) and its damping U(0, 0), in that order body by body, from
the task's ``numpy.random.RandomState`` (``task_kwargs={"random": seed}``).
Nothing else of the compiled model depends on the draw, so each size is
one asset, and ``jnt_stiffness`` and ``dof_damping`` come from the same
draws as the JAX package's ``get_model``.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from dm_control_torch.suite import base
from dm_control_torch.utils import containers

TIME_LIMIT = float("inf")
CONTROL_TIMESTEP = None
_CONTROL_COST_COEF = 0.1


def seeded_fields(n_bodies, random):
    """The model fields that depend on the seed: {"jnt_stiffness",
    "dof_damping"}, each (n_bodies,), drawn as
    ``dm_control_tpu/suite/lqr.py::_extend`` draws them."""
    if not isinstance(random, np.random.RandomState):
        random = np.random.RandomState(random)
    draws = np.array([(random.uniform(15, 25), random.uniform(0, 0))
                      for _ in range(n_bodies)])
    return {"jnt_stiffness": draws[:, 0], "dof_damping": draws[:, 1]}


class LQRLevel(base.Task):
    """Quadratic regulator task; an episode starts at a random position of
    norm sqrt(2), at rest, and ends when the state's norm is below
    1e-6."""

    _TERMINAL_TOL = 1e-6

    def __init__(self, control_cost_coef):
        if control_cost_coef <= 0:
            raise ValueError("control_cost_coef must be positive.")
        self.control_cost_coef = control_cost_coef

    def init(self, m, qpos, qvel, rc, diff):
        unit = rc.randn(m.nq)
        qpos = math.sqrt(2) * unit / torch.linalg.vector_norm(
            unit, dim=-1, keepdim=True)
        return qpos, qvel, diff

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["position"] = d.qpos
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        state_cost = 0.5 * torch.sum(d.qpos * d.qpos, -1)
        control_cost = 0.5 * torch.sum(d.ctrl * d.ctrl, -1)
        return 1 - (state_cost + control_cost * self.control_cost_coef)

    def termination(self, m, d):
        norm = torch.sqrt(torch.sum(d.qpos * d.qpos, -1)
                          + torch.sum(d.qvel * d.qvel, -1))
        return norm < self._TERMINAL_TOL, torch.zeros_like(norm)


def _make(n_bodies, n_actuators, random=None):
    fields = seeded_fields(n_bodies, random)

    def edit(m):
        return m.replace(**{k: torch.as_tensor(v, dtype=m.dtype,
                                               device=m.device)
                            for k, v in fields.items()})

    return (f"lqr_{n_bodies}_{n_actuators}", LQRLevel(_CONTROL_COST_COEF),
            edit)


TASKS = containers.TaggedTasks()


@TASKS.add()
def lqr_2_1(random=None):
    return _make(2, 1, random)


@TASKS.add()
def lqr_6_2(random=None):
    return _make(6, 2, random)
