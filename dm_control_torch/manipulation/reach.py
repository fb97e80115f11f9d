"""Reach tasks (counterpart of ``dm_control_tpu/manipulation/reach.py``;
reference: dm_control/manipulation/reach.py:61-200).

``reach_site``: move the pinch site to a target site, drawn per episode
(on the host the task keeps it, ``_target_pos``; on the batched path it is
a per-environment ``site_pos``).  ``reach_duplo``: move the pinch site to
a free Duplo brick, placed per episode.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from dm_control_torch.composer.observation.observable import Generic
from dm_control_torch.entities.props.duplo import Duplo
from dm_control_torch.manipulation.shared import constants, registry
from dm_control_torch.manipulation.shared import observations as obs_mod
from dm_control_torch.manipulation.shared import workspaces
from dm_control_torch.manipulation.shared.task import ArmTask
from dm_control_torch.utils import rewards

_TARGET_RADIUS = 0.05  # reference reach.py:61

_TARGET_BOX = workspaces.BoundingBox(
    lower=(-0.2, -0.1, 0.05), upper=(0.2, 0.2, 0.35))
_PROP_BOX = workspaces.BoundingBox(
    lower=(-0.2, -0.1, 0.02), upper=(0.2, 0.2, 0.02))


class Reach(ArmTask):
    """Bring the pinch site within ``_TARGET_RADIUS`` of the target
    (reference reach.py:95 `_Reach`)."""

    def __init__(self, use_site, obs_settings=None):
        super().__init__(obs_settings=obs_settings)
        self._use_site = use_site
        self._target_pos = np.zeros(3)
        if use_site:
            self._prop = None
            wb = self._arena.mjcf_model.first("worldbody")
            self._target_site = wb.add(
                "site", name="target", type="sphere",
                size=str(_TARGET_RADIUS),
                rgba=" ".join(map(str, constants.RED)),
                group=str(constants.TASK_SITE_GROUP))
        else:
            self._prop = Duplo(name="brick")
            self._add_free_prop(self._prop)
            if self._obs_settings.prop_pose.enabled:
                self._prop.observables.enable_all()

        def target_obs(physics):
            return np.asarray(self._target_position(physics), float)

        self._task_observables["target_position"] = Generic(target_obs)
        self._task_observables["target_position"].enabled = (
            self._obs_settings.prop_pose.enabled)

    # -- host hooks -----------------------------------------------------------

    def _target_position(self, physics):
        if self._prop is not None:
            return self._prop.position(physics)
        return self._target_pos

    def initialize_episode(self, physics, random_state):
        super().initialize_episode(physics, random_state)
        if self._prop is not None:
            self._place_prop(physics, self._prop, _PROP_BOX, random_state)
        else:
            self._target_pos = workspaces.uniform_in_box(
                _TARGET_BOX, random_state)

    def get_reward(self, physics):
        # reference reach.py:153
        distance = float(np.linalg.norm(
            self._pinch_position(physics) - self._target_position(physics)))
        return rewards.tolerance(distance, bounds=(0, _TARGET_RADIUS),
                                 margin=_TARGET_RADIUS)

    # -- batched path (composer.batch.BatchableTask) --------------------------

    def _target_site_id(self, m):
        return m.cached(("site", "target"), lambda: m.names.site["target"])

    def batch_model_diff(self, m):
        if self._use_site:
            return {"site_pos": m.site_pos}
        return {}

    def batch_init(self, m, qpos, qvel, rc, diff):
        qpos = self._batch_randomize_arm(m, qpos, rc)
        if self._prop is not None:
            adr, _ = self._free_joint(m, self._prop)
            qpos[:, adr:adr + 3] = workspaces.batch_uniform_in_box(
                m, _PROP_BOX, rc)
        else:
            tpos = workspaces.batch_uniform_in_box(m, _TARGET_BOX, rc)
            site_pos = diff["site_pos"].expand(
                (rc.batch,) + tuple(m.site_pos.shape)).clone()
            site_pos[:, self._target_site_id(m)] = tpos
            diff = dict(diff, site_pos=site_pos)
        return qpos, qvel, diff

    def _batch_target_pos(self, m, d):
        if self._prop is not None:
            _, bid = self._free_joint(m, self._prop)
            return d.xpos[:, bid]
        return d.site_xpos[:, self._target_site_id(m)]

    def batch_observation(self, m, d):
        obs = collections.OrderedDict()
        self._batch_arm_obs(m, d, obs)
        obs["target_position"] = self._batch_target_pos(m, d)
        obs["pinch_position"] = d.site_xpos[:, self._pinch_site_id(m)]
        return obs

    def batch_reward(self, m, d):
        distance = torch.linalg.vector_norm(
            d.site_xpos[:, self._pinch_site_id(m)]
            - self._batch_target_pos(m, d), dim=-1)
        return rewards.tolerance(distance, bounds=(0, _TARGET_RADIUS),
                                 margin=_TARGET_RADIUS)


@registry.add(registry.tags.FEATURES, registry.tags.EASY)
def reach_site_features():
    return Reach(use_site=True, obs_settings=obs_mod.PERFECT_FEATURES)


@registry.add(registry.tags.VISION, registry.tags.EASY)
def reach_site_vision():
    return Reach(use_site=True, obs_settings=obs_mod.VISION)


@registry.add(registry.tags.FEATURES, registry.tags.EASY)
def reach_duplo_features():
    return Reach(use_site=False, obs_settings=obs_mod.PERFECT_FEATURES)


@registry.add(registry.tags.VISION, registry.tags.EASY)
def reach_duplo_vision():
    return Reach(use_site=False, obs_settings=obs_mod.VISION)
