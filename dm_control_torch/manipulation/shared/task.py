"""Common base of the arm manipulation tasks, batched.

Counterpart of ``dm_control_tpu/manipulation/shared/task.py``: the Jaco
arm and hand in the standard arena, with the batched helpers its tasks
share.  Every lookup of a name in the model (joint addresses, home
angles, the pinch site, a free prop's joint) is made once per model and
kept in its cache.
"""

from __future__ import annotations

import os

from dm_control_torch.composer.batch import BatchableTask
from dm_control_torch.entities.manipulators.kinova import JacoArm, JacoHand
from dm_control_torch.manipulation.shared import constants
from dm_control_torch.manipulation.shared import observations as obs_mod

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def asset_path(asset: str) -> str:
    """The compiled model ``manipulation/assets/<asset>.npz``."""
    return os.path.join(_ASSET_DIR, asset + ".npz")


class ArmTask(BatchableTask):
    """Arena + Jaco arm + hand; subclasses add props and rewards.
    ``asset`` names the compiled model of the task's entity tree."""

    control_timestep = constants.CONTROL_TIMESTEP
    physics_timestep = constants.PHYSICS_TIMESTEP

    def __init__(self, asset, obs_settings=None):
        self._obs_settings = obs_settings or obs_mod.PERFECT_FEATURES
        self._arm = JacoArm(name="arm")
        self._hand = JacoHand(name="hand")
        self.model_asset = asset_path(asset)

    @property
    def obs_settings(self):
        return self._obs_settings

    # -- batched helpers ------------------------------------------------------

    def _arm_joint_ids(self, m):
        return [m.names.joint[f"{self._arm.name}/{j}"]
                for j in self._arm.joints]

    def _arm_joint_mids(self, m):
        """Per-joint home angle (nj,): mid-range for limited joints, 0 for
        unlimited (the Jaco's joint_2/joint_3 ranges exclude 0)."""
        def build():
            mids = []
            for j in self._arm_joint_ids(m):
                lo, hi = m.jnt_range[j].cpu().tolist()
                mids.append(0.5 * (lo + hi) if m.jnt_limited[j] else 0.0)
            return m.const(("arm_mids", self._arm.name), mids)
        return m.cached(("arm_mids", self._arm.name), build)

    def _arm_qpos_addrs(self, m):
        return m.cached(("arm_qpos", self._arm.name), lambda: m.idx(
            [m.jnt_qposadr[j] for j in self._arm_joint_ids(m)]))

    def _arm_dof_addrs(self, m):
        return m.cached(("arm_dof", self._arm.name), lambda: m.idx(
            [m.jnt_dofadr[j] for j in self._arm_joint_ids(m)]))

    def _pinch_site_id(self, m):
        name = (f"{self._arm.name}/{self._hand.name}/"
                f"{self._hand.pinch_site_name}")
        return m.cached(("site", name), lambda: m.names.site[name])

    def _free_joint(self, m, entity):
        """(qpos_adr, body_id) of a free entity's root joint (named
        '<frame>_root' when the arena adds it)."""
        def build():
            for name, j in m.names.joint.items():
                if name.startswith(entity.name) and name.endswith("_root"):
                    return int(m.jnt_qposadr[j]), int(m.jnt_bodyid[j])
            raise KeyError(f"no free root joint for entity {entity.name!r}")
        return m.cached(("free_joint", entity.name), build)

    def _batch_randomize_arm(self, m, qpos, rc):
        """qpos with the arm's angles drawn around its home pose: mid-range
        + uniform(-0.2, 0.2)."""
        angles = self._arm_joint_mids(m) + rc.uniform(
            -0.2, 0.2, len(self._arm.joints))
        qpos = qpos.clone()
        qpos[:, self._arm_qpos_addrs(m)] = angles
        return qpos

    def _batch_arm_obs(self, m, d, obs):
        obs["arm/joints_pos"] = d.qpos[:, self._arm_qpos_addrs(m)]
        obs["arm/joints_vel"] = d.qvel[:, self._arm_dof_addrs(m)]
        return obs
