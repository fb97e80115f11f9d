"""The position-controlled CMU humanoid of 2020, as names (counterpart of
``dm_control_tpu/locomotion/walkers/cmu_humanoid.py``).

Its 56 hinge joints, each driven by a position actuator through a 30 ms
filter, the 30 bodies the mocap pipeline tracks and the four end
effectors come from the JAX walker's MJCF tree, written beside the
tracking model by ``tools/export_torch_assets.py tracking``
(``locomotion/assets/tracking_cmu2020_walker.json``).
"""

from __future__ import annotations

import functools
import json
import os

from dm_control_torch.locomotion import ASSET_DIR
from dm_control_torch.locomotion.walkers import base

NAMES_PATH = os.path.join(ASSET_DIR, "tracking_cmu2020_walker.json")


@functools.lru_cache(maxsize=None)
def _names():
    with open(NAMES_PATH) as f:
        return json.load(f)


class CMUHumanoidPositionControlledV2020(base.Walker):
    """The CMU humanoid with position actuators in [-1, 1], per-joint
    damping and filtered activations (the 2020 revision)."""

    def __init__(self, name="walker"):
        super().__init__(name)

    @property
    def root_body_name(self):
        return _names()["root_body_name"]

    @property
    def observable_joint_names(self):
        return tuple(_names()["observable_joint_names"])

    @property
    def mocap_joint_names(self):
        return self.observable_joint_names

    @property
    def end_effector_body_names(self):
        return tuple(_names()["end_effector_body_names"])

    @property
    def mocap_tracking_body_names(self):
        """Every body but the root, in the model's order: the columns of
        a clip's body features."""
        return tuple(_names()["mocap_tracking_body_names"])
