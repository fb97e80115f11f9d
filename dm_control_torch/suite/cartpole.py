"""Cartpole domain, batched (reference: dm_control/suite/cartpole.py).

The two- and three-pole models are assets of their own
(``cartpole_2.npz``, ``cartpole_3.npz``): the JAX package builds them
procedurally before it compiles them.
"""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.suite import base
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 10
CONTROL_TIMESTEP = None
#: pole count -> the compiled model
_POLE_ASSETS = {1: "cartpole", 2: "cartpole_2", 3: "cartpole_3"}


class Balance(base.Task):
    """Keep the pole(s) upright, from near the top or from hanging."""

    _CART_RANGE = (-0.25, 0.25)
    _ANGLE_COSINE_RANGE = (0.995, 1)

    def __init__(self, swing_up, sparse):
        self._swing_up = swing_up
        self._sparse = sparse

    def init(self, m, qpos, qvel, rc, diff):
        nv = m.nv
        qpos = qpos.clone()
        if self._swing_up:
            qpos[:, 0] = 0.01 * rc.randn()  # slider
            qpos[:, 1] = math.pi + 0.01 * rc.randn()  # hinge_1
            qpos[:, 2:] = 0.1 * rc.randn(nv - 2)
        else:
            qpos[:, 0] = rc.uniform(-0.1, 0.1)
            qpos[:, 1:] = rc.uniform(-0.034, 0.034, nv - 1)
        return qpos, 0.01 * rc.randn(nv), diff

    def _pole_angle_cosine(self, m, d):
        return d.xmat[:, 2:, 2, 2]

    def observation(self, m, d):
        obs = collections.OrderedDict()
        # [zz, xz] of every pole body, pole-major
        pole = torch.stack([d.xmat[:, 2:, 2, 2], d.xmat[:, 2:, 0, 2]], -1)
        obs["position"] = torch.cat(
            [self.joint_qpos(m, d, "slider").unsqueeze(-1),
             pole.flatten(1)], -1)
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        cart = self.joint_qpos(m, d, "slider")
        if self._sparse:
            cart_in_bounds = rewards.tolerance(cart, self._CART_RANGE)
            angle_in_bounds = torch.prod(rewards.tolerance(
                self._pole_angle_cosine(m, d), self._ANGLE_COSINE_RANGE), -1)
            return cart_in_bounds * angle_in_bounds
        upright = (self._pole_angle_cosine(m, d) + 1) / 2
        centered = (1 + rewards.tolerance(cart, margin=2)) / 2
        small_control = rewards.tolerance(
            d.ctrl, margin=1, value_at_margin=0, sigmoid="quadratic")[:, 0]
        small_control = (4 + small_control) / 5
        small_velocity = torch.amin(rewards.tolerance(d.qvel[:, 1:],
                                                      margin=5), -1)
        small_velocity = (1 + small_velocity) / 2
        return torch.mean(upright, -1) * small_control * small_velocity \
            * centered


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def balance():
    return "cartpole", Balance(False, False)


@TASKS.add("benchmarking")
def balance_sparse():
    return "cartpole", Balance(False, True)


@TASKS.add("benchmarking")
def swingup():
    return "cartpole", Balance(True, False)


@TASKS.add("benchmarking")
def swingup_sparse():
    return "cartpole", Balance(True, True)


@TASKS.add()
def two_poles():
    return "cartpole_2", Balance(True, False)


@TASKS.add()
def three_poles(num_poles=3, sparse=False):
    if num_poles not in _POLE_ASSETS:
        raise NotImplementedError(
            f"three_poles(num_poles={num_poles}): the port has the models "
            f"of {sorted(_POLE_ASSETS)} poles; others need the MJCF "
            f"compiler (ROADMAP A9)")
    return _POLE_ASSETS[num_poles], Balance(True, sparse)
