"""Ball-in-cup domain, batched (reference:
dm_control/suite/ball_in_cup.py).  The string is a spatial tendon with a
length limit."""

from __future__ import annotations

import collections

import torch

from dm_control_torch.physics import engine
from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.ball_in_cup import MODEL
from dm_control_torch.utils import containers

TIME_LIMIT = 20
CONTROL_TIMESTEP = 0.02


class BallInCup(base.Task):
    """Catch the ball in the cup; the ball's initial position is redrawn
    until it penetrates nothing."""

    max_reset_rejections = 100

    def init(self, m, qpos, qvel, rc, diff):
        qpos = self.set_joint_qpos(m, qpos, "ball_x", rc.uniform(-0.2, 0.2))
        qpos = self.set_joint_qpos(m, qpos, "ball_z", rc.uniform(0.2, 0.5))
        return qpos, qvel, diff

    def reject(self, m, d):
        d = engine.fwd_position(m, d)
        return (d.contact.dist < 0).any(-1)

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["position"] = d.qpos
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        xz = m.idx([0, 2])
        target = m.names.site["target"]
        ball_to_target = torch.abs(
            d.site_xpos[:, target][:, xz]
            - self.xpos(m, d, "ball")[:, xz])
        room = m.site_size[target, xz] \
            - m.geom_size[m.names.geom["ball"], 0]
        return (ball_to_target < room).all(-1).to(d.qpos.dtype)


def get_model(device=None, dtype: torch.dtype = torch.float64):
    """The domain's model, compiled from its literal tree (reference:
    dm_control/suite/ball_in_cup.xml)."""
    return compile_domain_model(MODEL, device=device, dtype=dtype)


_MODEL = base.Variant("ball_in_cup", get_model)


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking", "easy")
def catch():
    return _MODEL, BallInCup()
