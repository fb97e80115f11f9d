"""Cheetah domain, batched (reference: dm_control/suite/cheetah.py)."""

from __future__ import annotations

import collections

import torch

from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.cheetah import MODEL
from dm_control_torch.utils import containers, rewards

_RUN_SPEED = 10

TIME_LIMIT = 10
CONTROL_TIMESTEP = None


class Cheetah(base.Task):
    """Run forward fast.  Every episode starts with 200 physics steps that
    let the drawn pose settle on the floor; then time is set to 0."""

    settle_steps = 200

    def init(self, m, qpos, qvel, rc, diff):
        limited = [j for j in range(m.njnt) if m.jnt_limited[j]]
        jr = m.jnt_range[m.idx(limited)]
        qpos = qpos.clone()
        qpos[:, m.idx([m.jnt_qposadr[j] for j in limited])] = rc.uniform(
            jr[:, 0], jr[:, 1], len(limited))
        return qpos, qvel, diff

    def observation(self, m, d):
        obs = collections.OrderedDict()
        obs["position"] = d.qpos[:, 1:]
        obs["velocity"] = d.qvel
        return obs

    def reward(self, m, d):
        speed = self.sensordata(m, d, "torso_subtreelinvel")[:, 0]
        return rewards.tolerance(speed, bounds=(_RUN_SPEED, float("inf")),
                                 margin=_RUN_SPEED, value_at_margin=0,
                                 sigmoid="linear")


def get_model(device=None, dtype: torch.dtype = torch.float64):
    """The domain's model, compiled from its literal tree (reference:
    dm_control/suite/cheetah.xml)."""
    return compile_domain_model(MODEL, device=device, dtype=dtype)


_MODEL = base.Variant("cheetah", get_model)


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def run():
    return _MODEL, Cheetah()
