"""Lift tasks (counterpart of ``dm_control_tpu/manipulation/lift.py``;
reference: dm_control/manipulation/lift.py:60-240).

``lift_brick``: raise a Duplo brick 0.3 m above its initial height.
``lift_large_box``: the same with a large box that cannot be
pinch-grasped.

Height is measured at the prop's lowest vertex site (reference lift.py:63
`_VertexSitesMixin`): tipping the prop up on one edge does not count as
lifting it.  Each episode's target height is kept by the task on the host
and is a per-environment diff, ``_target_height``, read as
``m.task_state``, on the batched path.
"""

from __future__ import annotations

import collections
import math

import numpy as np
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


def _add_vertex_sites(body, center, half_size):
    """Adds 8 corner sites to ``body``; returns their (local) names."""
    names = []
    for i in range(8):
        sign = np.array([(-1, 1)[(i >> k) & 1] for k in range(3)])
        pos = np.asarray(center) + sign * np.asarray(half_size)
        name = f"vertex_{i}"
        body.add("site", name=name, pos=" ".join(f"{v:g}" for v in pos),
                 type="sphere", size="0.002", group="3")
        names.append(name)
    return names


class _VertexSitesMixin:
    """The prop's eight corner sites ``<name>/vertex_<i>`` (reference
    lift.py:63)."""

    _vertex_names = ()

    def vertex_site_names(self):
        """Fully-qualified vertex site names (valid once attached)."""
        return [f"{self.name}/{n}" for n in self._vertex_names]

    def lowest_vertex_height(self, physics):
        return min(
            float(np.asarray(physics.named_field("site_xpos", n))[2])
            for n in self.vertex_site_names())

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
    """Duplo with sites at the corners of its bounding site
    (reference lift.py:93)."""

    def _build(self, **kwargs):
        super()._build(**kwargs)
        body = self._mjcf_root.find("body", "brick")
        self._vertex_names = _add_vertex_sites(
            body, center=(0, 0, 0.0119), half_size=(0.016, 0.0319, 0.012))


class _BoxWithVertexSites(Primitive, _VertexSitesMixin):
    """Box with corner vertex sites (reference lift.py:85)."""

    def _build(self, size, **kwargs):
        super()._build(geom_type="box", size=size, **kwargs)
        self._vertex_names = _add_vertex_sites(
            self.geom.parent, center=(0, 0, 0), half_size=size)


class Lift(ArmTask):
    """Raise the prop above a target height (reference lift.py:100
    `_Lift`)."""

    def __init__(self, prop, obs_settings=None):
        super().__init__(obs_settings=obs_settings)
        self._prop = prop
        self._add_free_prop(prop)
        if self._obs_settings.prop_pose.enabled:
            prop.observables.enable_all()
        self._target_height = 0.0
        self._init_height = 0.0

    # -- host hooks -----------------------------------------------------------

    def initialize_episode(self, physics, random_state):
        super().initialize_episode(physics, random_state)
        self._place_prop(physics, self._prop, _PROP_BOX, random_state)
        physics.forward()
        self._init_height = self._prop.lowest_vertex_height(physics)
        # reference lift.py:190
        self._target_height = _DISTANCE_TO_LIFT + self._init_height

    def get_reward(self, physics):
        # reference lift.py:179 — linear shaping from initial to target
        # height (of the LOWEST vertex), plus a small reach-shaping term
        # to guide the arm.
        prop_height = self._prop.lowest_vertex_height(physics)
        lift = rewards.tolerance(
            prop_height, bounds=(self._target_height, float("inf")),
            margin=_DISTANCE_TO_LIFT, value_at_margin=0.0,
            sigmoid="linear")
        reach_dist = float(np.linalg.norm(
            self._pinch_position(physics) - self._prop.position(physics)))
        reach = rewards.tolerance(reach_dist, bounds=(0, 0.05),
                                  margin=0.3)
        return 0.8 * lift + 0.2 * reach

    # -- batched path (composer.batch.BatchableTask) --------------------------

    def batch_model_diff(self, m):
        return {"_target_height": torch.zeros((), dtype=m.dtype,
                                              device=m.device)}

    def batch_init(self, m, qpos, qvel, rc, diff):
        qpos = self._batch_randomize_arm(m, qpos, rc)
        adr, _ = self._free_joint(m, self._prop)
        pos = workspaces.batch_uniform_in_box(m, _PROP_BOX, rc)
        qpos[:, adr:adr + 3] = pos
        # reference lift.py:190: the initial height of the LOWEST vertex
        # (unrotated at spawn) + the lift distance
        diff = dict(diff, _target_height=(
            pos[:, 2] + self._prop.lowest_vertex_offset(m)
            + _DISTANCE_TO_LIFT))
        return qpos, qvel, diff

    @staticmethod
    def _batch_target_height(m, d):
        """The episodes' target heights (B,)."""
        return m.task_state["_target_height"].expand(d.qpos.shape[0])

    def batch_observation(self, m, d):
        obs = collections.OrderedDict()
        self._batch_arm_obs(m, d, obs)
        _, bid = self._free_joint(m, self._prop)
        obs["prop_position"] = d.xpos[:, bid]
        obs["prop_quaternion"] = d.xquat[:, bid]
        obs["pinch_position"] = d.site_xpos[:, self._pinch_site_id(m)]
        obs["target_height"] = self._batch_target_height(m, d)[:, None]
        return obs

    def batch_reward(self, m, d):
        _, bid = self._free_joint(m, self._prop)
        prop_height = d.site_xpos[:, self._prop.vertex_site_ids(m), 2].min(
            -1).values
        lift = rewards.tolerance(
            prop_height, bounds=(self._batch_target_height(m, d), math.inf),
            margin=_DISTANCE_TO_LIFT, value_at_margin=0.0,
            sigmoid="linear")
        reach_dist = torch.linalg.vector_norm(
            d.site_xpos[:, self._pinch_site_id(m)] - d.xpos[:, bid], dim=-1)
        reach = rewards.tolerance(reach_dist, bounds=(0, 0.05), margin=0.3)
        return 0.8 * lift + 0.2 * reach


def _make(prop_name, obs_settings):
    if prop_name == "brick":
        prop = _DuploWithVertexSites(name="brick")
    else:
        prop = _BoxWithVertexSites(size=(0.06, 0.06, 0.06),
                                   mass=0.3, name="large_box",
                                   friction="1.5 0.01 0.001")
    return Lift(prop, obs_settings=obs_settings)


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
