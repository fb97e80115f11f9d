"""Cartpole domain, batched (reference: dm_control/suite/cartpole.py).

The models of more than one pole extend the single-pole tree into a chain
before it is compiled, as the JAX package's ``get_model`` does, for any
number of poles.
"""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.cartpole import MODEL
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 10
CONTROL_TIMESTEP = None


def _add_poles(root, n_poles):
    """Extends the single-pole model into an n-pole chain."""
    worldbody = root.first("worldbody")
    cart = next(b for b in worldbody.children if b.tag == "body")
    parent = next(b for b in cart.children if b.tag == "body")  # first pole
    for i in range(2, n_poles + 1):
        child = parent.add("body", name=f"pole_{i}", pos="0 0 1",
                           childclass="pole")
        child.add("joint", name=f"hinge_{i}")
        child.add("geom", name=f"pole_{i}")
        parent = child
    floor = next(g for g in worldbody.children if g.tag == "geom")
    floor.attrib["pos"] = f"0 0 {1 - n_poles - .05}"


def get_model(num_poles=1, device=None, dtype: torch.dtype = torch.float64):
    """The model of a cart with a chain of ``num_poles`` poles."""
    if num_poles == 1:
        return compile_domain_model(MODEL, device=device, dtype=dtype)
    return compile_domain_model(
        MODEL, mutate=lambda r: _add_poles(r, num_poles),
        cache_key=num_poles, device=device, dtype=dtype)


def _model(num_poles):
    name = "cartpole" if num_poles == 1 else f"cartpole_{num_poles}"
    return base.Variant(name, lambda device, dtype: get_model(
        num_poles, device, dtype))


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
    return _model(1), Balance(False, False)


@TASKS.add("benchmarking")
def balance_sparse():
    return _model(1), Balance(False, True)


@TASKS.add("benchmarking")
def swingup():
    return _model(1), Balance(True, False)


@TASKS.add("benchmarking")
def swingup_sparse():
    return _model(1), Balance(True, True)


@TASKS.add()
def two_poles():
    return _model(2), Balance(True, False)


@TASKS.add()
def three_poles(num_poles=3, sparse=False):
    return _model(num_poles), Balance(True, sparse)
