"""Lift tasks, batched (counterpart of
``dm_control_tpu/manipulation/lift.py``).

``lift_brick``: raise a Duplo brick 0.3 m above its initial height.
``lift_large_box``: the same with a large box that cannot be
pinch-grasped.

Height is measured at the prop's lowest vertex site (reference lift.py:63
`_VertexSitesMixin`): tipping the prop up on one edge does not count as
lifting it.  Each episode's target height is a per-environment diff,
``_target_height``, read as ``m.task_state``.
"""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.entities.props.duplo import Duplo
from dm_control_torch.entities.props.primitive import Primitive
from dm_control_torch.manipulation.shared import registry
from dm_control_torch.manipulation.shared import observations as obs_mod
from dm_control_torch.manipulation.shared import workspaces
from dm_control_torch.manipulation.shared.task import ArmTask
from dm_control_torch.utils import rewards

_DISTANCE_TO_LIFT = 0.3  # reference lift.py:60

_PROP_BOX = workspaces.BoundingBox(
    lower=(-0.15, -0.1, 0.02), upper=(0.15, 0.15, 0.08))


class _VertexSitesMixin:
    """The prop's eight corner sites ``<name>/vertex_<i>`` (reference
    lift.py:63)."""

    def vertex_site_names(self):
        return [f"{self.name}/vertex_{i}" for i in range(8)]

    def vertex_site_ids(self, m):
        return m.cached(("vertex_sites", self.name), lambda: m.idx(
            [m.names.site[n] for n in self.vertex_site_names()]))

    def lowest_vertex_offset(self, m):
        """z of the lowest vertex above the prop's body origin, in the
        body's frame (the batched init spawns props unrotated): the
        smallest z of the vertex sites' positions in the model."""
        return m.cached(("lowest_vertex", self.name), lambda: float(
            m.site_pos[self.vertex_site_ids(m), 2].min()))


class _DuploWithVertexSites(Duplo, _VertexSitesMixin):
    """Duplo with sites at the corners of its bounding box (reference
    lift.py:93)."""


class _BoxWithVertexSites(Primitive, _VertexSitesMixin):
    """Box with corner vertex sites (reference lift.py:85): the model's
    0.06 m half-size box of 0.3 kg."""


class Lift(ArmTask):
    """Raise the prop above a target height (reference lift.py:100
    `_Lift`)."""

    def __init__(self, asset, prop, obs_settings=None):
        super().__init__(asset, obs_settings=obs_settings)
        self._prop = prop

    def batch_model_diff(self, m):
        return {"_target_height": torch.zeros((), dtype=m.dtype,
                                              device=m.device)}

    def batch_init(self, m, qpos, qvel, rc, diff):
        qpos = self._batch_randomize_arm(m, qpos, rc)
        adr, _ = self._free_joint(m, self._prop)
        pos = workspaces.uniform_in_box(m, _PROP_BOX, rc)
        qpos[:, adr:adr + 3] = pos
        # reference lift.py:190: the initial height of the LOWEST vertex
        # (unrotated at spawn) + the lift distance
        diff = dict(diff, _target_height=(
            pos[:, 2] + self._prop.lowest_vertex_offset(m)
            + _DISTANCE_TO_LIFT))
        return qpos, qvel, diff

    @staticmethod
    def _target_height(m, d):
        """The episodes' target heights (B,)."""
        return m.task_state["_target_height"].expand(d.qpos.shape[0])

    def batch_observation(self, m, d):
        obs = collections.OrderedDict()
        self._batch_arm_obs(m, d, obs)
        _, bid = self._free_joint(m, self._prop)
        obs["prop_position"] = d.xpos[:, bid]
        obs["prop_quaternion"] = d.xquat[:, bid]
        obs["pinch_position"] = d.site_xpos[:, self._pinch_site_id(m)]
        obs["target_height"] = self._target_height(m, d)[:, None]
        return obs

    def batch_reward(self, m, d):
        _, bid = self._free_joint(m, self._prop)
        prop_height = d.site_xpos[:, self._prop.vertex_site_ids(m), 2].min(
            -1).values
        lift = rewards.tolerance(
            prop_height, bounds=(self._target_height(m, d), math.inf),
            margin=_DISTANCE_TO_LIFT, value_at_margin=0.0,
            sigmoid="linear")
        reach_dist = torch.linalg.vector_norm(
            d.site_xpos[:, self._pinch_site_id(m)] - d.xpos[:, bid], dim=-1)
        reach = rewards.tolerance(reach_dist, bounds=(0, 0.05), margin=0.3)
        return 0.8 * lift + 0.2 * reach


def _make(prop_name, obs_settings):
    if prop_name == "brick":
        return Lift("lift_brick", _DuploWithVertexSites(name="brick"),
                    obs_settings=obs_settings)
    return Lift("lift_large_box", _BoxWithVertexSites(name="large_box"),
                obs_settings=obs_settings)


@registry.add(registry.tags.FEATURES, registry.tags.EASY)
def lift_brick_features():
    return _make("brick", obs_mod.PERFECT_FEATURES)


@registry.add(registry.tags.VISION, registry.tags.EASY)
def lift_brick_vision():
    return _make("brick", obs_mod.VISION)


@registry.add(registry.tags.FEATURES, registry.tags.EASY)
def lift_large_box_features():
    return _make("large_box", obs_mod.PERFECT_FEATURES)


@registry.add(registry.tags.VISION, registry.tags.EASY)
def lift_large_box_vision():
    return _make("large_box", obs_mod.VISION)
