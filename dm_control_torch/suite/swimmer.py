"""Swimmer domain, batched (reference: dm_control/suite/swimmer.py).

A planar chain of links propelled by the drag of the medium; contacts are
disabled.  The chain of any length is built onto the head's tree before
it is compiled, as the JAX package's ``get_model`` does.  Each episode
places the target anew: the task overrides ``geom_pos`` per environment,
(B, ngeom, 3).
"""

from __future__ import annotations

import collections

import torch

from dm_control_torch.physics import mathx as mx
from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.swimmer import MODEL
from dm_control_torch.suite.utils import randomizers
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 30
CONTROL_TIMESTEP = 0.03
#: columns of ``sensordata`` before the links' velocimeter and gyro pairs
_HEAD_SENSOR_VALUES = 12


def _extend(root, n_bodies):
    """Builds the n-link chain (reference swimmer.py:_make_model)."""
    if n_bodies < 3:
        raise ValueError(f"At least 3 bodies required. Received {n_bodies}")
    wb = root.first("worldbody")
    head = next(b for b in wb.children if b.tag == "body")
    actuator = root.add("actuator")
    sensor = root.first("sensor") or root.add("sensor")
    parent = head
    joint_limit = 360.0 / n_bodies
    for i in range(n_bodies - 1):
        child = parent.add("body", name=f"segment_{i}", pos="0 .1 0")
        child.add("geom", **{"class": "visual", "name": f"visual_{i}"})
        child.add("geom", **{"class": "inertial", "name": f"inertial_{i}"})
        child.add("site", name=f"site_{i}")
        child.add("joint", name=f"joint_{i}",
                  range=f"{-joint_limit} {joint_limit}")
        actuator.add("motor", name=f"motor_{i}", joint=f"joint_{i}")
        sensor.add("velocimeter", name=f"velocimeter_{i}", site=f"site_{i}")
        sensor.add("gyro", name=f"gyro_{i}", site=f"site_{i}")
        parent = child


def get_model(n_links, device=None, dtype: torch.dtype = torch.float64):
    """The model of an ``n_links`` chain."""
    return compile_domain_model(
        MODEL, mutate=lambda r: _extend(r, n_links), cache_key=n_links,
        device=device, dtype=dtype)


def _model(n_links):
    return base.Variant(f"swimmer{n_links}", lambda device, dtype: get_model(
        n_links, device, dtype))


class Swimmer(base.Task):
    """Swim the nose to the target."""

    def initial_model_diff(self, m):
        return {"geom_pos": m.geom_pos}

    def init(self, m, qpos, qvel, rc, diff):
        qpos = randomizers.randomize_limited_and_rotational_joints(
            m, qpos, rc)
        # one episode in five has the target close by
        close = rc.rand() < 0.2
        tid = m.names.geom["target"]
        gp = diff["geom_pos"].expand(rc.batch, m.ngeom, 3).clone()
        if rc.is_numpy:  # the reference's draw, which rounds otherwise
            box = 0.3 if bool(close) else 2.0
            gp[:, tid, :2] = rc.uniform(-box, box, 2)
        else:
            box = torch.where(close, 0.3, 2.0).to(qpos.dtype)
            gp[:, tid, :2] = rc.uniform(-1.0, 1.0, 2) * box.unsqueeze(-1)
        return qpos, qvel, dict(diff, geom_pos=gp)

    def _nose_to_target(self, m, d):
        nose_to_target = (self.geom_xpos(m, d, "target")
                          - self.geom_xpos(m, d, "nose"))
        head = d.xmat[:, m.names.body["head"]]
        return mx.mat_t_vec(head, nose_to_target)[:, :2]

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["joints"] = d.qpos[:, 3:]
        obs["to_target"] = self._nose_to_target(m, d)
        # [vx, vy, wz] of each link from its velocimeter and gyro pair
        B = d.qpos.shape[0]
        xvel_local = d.sensordata[:, _HEAD_SENSOR_VALUES:].reshape(B, -1, 6)
        obs["body_velocities"] = xvel_local[:, :, [0, 1, 5]].reshape(B, -1)
        return obs

    def reward(self, m, d):
        target_size = m.cached("swimmer_target_size", lambda: float(
            m.geom_size[m.names.geom["target"], 0]))
        return rewards.tolerance(
            mx.norm(self._nose_to_target(m, d)), bounds=(0, target_size),
            margin=5 * target_size, sigmoid="long_tail")


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def swimmer6():
    return _model(6), Swimmer()


@TASKS.add("benchmarking")
def swimmer15():
    return _model(15), Swimmer()


def swimmer(n_links=3):
    """A chain of any length (not a registered task, as in the JAX
    package)."""
    return _model(n_links), Swimmer()
