"""Place tasks (counterpart of ``dm_control_tpu/manipulation/place.py``;
reference: dm_control/manipulation/place.py:42-280).

``place_brick``: put a brick on top of a fixed pedestal.
``place_cradle``: put a ball into a cradle on the pedestal.
Reward (reference place.py:216-229): prop within ``_TARGET_RADIUS`` of
the placement site AND the hand withdrawn.  They run on composer's host
path only (``manipulation.load``), as in the JAX package: ``load_batch``
refuses them.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.entities.props.duplo import Duplo
from dm_control_torch.entities.props.primitive import Primitive
from dm_control_torch.manipulation.shared import constants, registry
from dm_control_torch.manipulation.shared import observations as obs_mod
from dm_control_torch.manipulation.shared import workspaces
from dm_control_torch.manipulation.shared.task import ArmTask
from dm_control_torch.utils import rewards

_TARGET_RADIUS = 0.05  # reference place.py:42

_PROP_BOX = workspaces.BoundingBox(
    lower=(-0.2, -0.1, 0.02), upper=(-0.05, 0.15, 0.02))
_PEDESTAL_POS = (0.15, 0.1, 0.075)


class Place(ArmTask):
    """Place the prop on the pedestal and withdraw the hand
    (reference place.py:140 `_Place`)."""

    def __init__(self, cradle, obs_settings=None):
        super().__init__(obs_settings=obs_settings)
        wb = self._arena.mjcf_model.first("worldbody")
        ped = wb.add("body", name="pedestal",
                     pos=" ".join(map(str, _PEDESTAL_POS)))
        ped.add("geom", name="pedestal_geom", type="box",
                size="0.07 0.07 0.075")
        if cradle:
            # cradle: two rails the ball must rest between
            # (reference entities/props/cradle, primitive substitute)
            for i, y in enumerate((-0.035, 0.035)):
                ped.add("geom", name=f"cradle_rail_{i}", type="capsule",
                        fromto=f"-0.05 {y} 0.08 0.05 {y} 0.08",
                        size="0.012")
            self._prop = Primitive(geom_type="sphere", size=(0.03,),
                                   mass=0.1, name="ball",
                                   friction="1.5 0.01 0.001")
            target_z = 0.075 + 0.08 + 0.02
        else:
            # the brick is a real stud-coupling Duplo (reference
            # place.py:255); its free-joint origin is at its base, so
            # the resting origin sits exactly on the pedestal top
            self._prop = Duplo(name="brick")
            target_z = 0.075 + 0.075
        self._placement_site = ped.add(
            "site", name="placement", type="sphere",
            pos=f"0 0 {target_z - 0.075}", size=str(_TARGET_RADIUS),
            rgba=" ".join(map(str, constants.GREEN)),
            group=str(constants.TASK_SITE_GROUP))
        self._target = np.array(
            [_PEDESTAL_POS[0], _PEDESTAL_POS[1], target_z])
        self._add_free_prop(self._prop)
        if self._obs_settings.prop_pose.enabled:
            self._prop.observables.enable_all()

    def initialize_episode(self, physics, random_state):
        super().initialize_episode(physics, random_state)
        self._place_prop(physics, self._prop, _PROP_BOX, random_state)

    def get_reward(self, physics):
        prop_pos = self._prop.position(physics)
        place_dist = float(np.linalg.norm(prop_pos - self._target))
        placed = rewards.tolerance(
            place_dist, bounds=(0, _TARGET_RADIUS), margin=_TARGET_RADIUS)
        hand_dist = float(np.linalg.norm(
            self._pinch_position(physics) - prop_pos))
        # reference place.py:228 — hand must withdraw 4 radii
        withdrawn = rewards.tolerance(
            hand_dist, bounds=(4 * _TARGET_RADIUS, float("inf")),
            margin=3 * _TARGET_RADIUS, sigmoid="linear",
            value_at_margin=0.0)
        reach = rewards.tolerance(hand_dist, bounds=(0, 0.05), margin=0.4)
        return placed * (0.5 + 0.5 * withdrawn) * 0.9 + 0.1 * reach


def _make(cradle, obs_settings):
    return Place(cradle=cradle, obs_settings=obs_settings)


@registry.add(registry.tags.FEATURES)
def place_brick_features():
    return _make(False, obs_mod.PERFECT_FEATURES)


@registry.add(registry.tags.VISION)
def place_brick_vision():
    return _make(False, obs_mod.VISION)


@registry.add(registry.tags.FEATURES)
def place_cradle_features():
    return _make(True, obs_mod.PERFECT_FEATURES)


@registry.add(registry.tags.VISION)
def place_cradle_vision():
    return _make(True, obs_mod.VISION)
