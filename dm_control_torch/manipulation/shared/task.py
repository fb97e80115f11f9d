"""Common base task for arm manipulation (counterpart of
``dm_control_tpu/manipulation/shared/task.py``).

Each task builds the Standard arena with the Kinova Jaco arm and hand
(``entities/manipulators/kinova.py``) and its props; the primitive arm
(``entities/manipulators/arm.py``) is there through ``use_jaco=False``.
The task is a composer ``Task`` over that entity tree, run by
``composer.Environment`` with the host helpers below, and a
``BatchableTask`` whose batched helpers read the same tree's compiled
model.  Every lookup of a name in a model (joint addresses, home angles,
the pinch site, a free prop's joint) is made once per model and kept in
its cache.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch import composer
from dm_control_torch.composer.batch import BatchableTask
from dm_control_torch.entities.manipulators.arm import (PrimitiveArm,
                                                        PrimitiveHand)
from dm_control_torch.entities.manipulators.kinova import JacoArm, JacoHand
from dm_control_torch.manipulation.shared import arenas, constants
from dm_control_torch.manipulation.shared import observations as obs_mod
from dm_control_torch.manipulation.shared import workspaces


class ArmTask(composer.Task, BatchableTask):
    """Arena + arm + hand; subclasses add props and rewards."""

    #: the episode length ``manipulation.load`` gives the environment
    time_limit = 10.0

    def __init__(self, obs_settings=None, use_jaco=True):
        self._obs_settings = obs_settings or obs_mod.PERFECT_FEATURES
        self._arena = arenas.Standard()
        if use_jaco:
            self._arm = JacoArm(name="arm")
            self._hand = JacoHand(name="hand")
        else:
            self._arm = PrimitiveArm(name="arm")
            self._hand = PrimitiveHand(name="hand")
        self._arm.attach_hand(self._hand)
        self._arena.attach_offset(self._arm, offset=(0, 0.4, 0))
        self._task_observables = {}
        if self._obs_settings.proprio.enabled:
            self._arm.observables.joints_pos.enabled = True
            self._arm.observables.joints_vel.enabled = True
        if self._obs_settings.ftt.enabled:
            self._arm.observables.joints_torque.enabled = True
        self.set_timesteps(constants.CONTROL_TIMESTEP,
                           constants.PHYSICS_TIMESTEP)

    @property
    def root_entity(self):
        return self._arena

    @property
    def arm(self):
        return self._arm

    @property
    def hand(self):
        return self._hand

    @property
    def obs_settings(self):
        return self._obs_settings

    @property
    def task_observables(self):
        return self._task_observables

    # -- host helpers ---------------------------------------------------------

    def _add_free_prop(self, prop):
        return self._arena.add_free_entity(prop)

    def _pinch_site_name(self):
        return (f"{self._arm.name}/{self._hand.name}/"
                f"{self._hand.pinch_site_name}")

    def _pinch_position(self, physics):
        """World position of the hand's pinch site."""
        return np.asarray(physics.named_field("site_xpos",
                                              self._pinch_site_name()))

    def _place_prop(self, physics, prop, box, random_state,
                    quaternion=(1.0, 0.0, 0.0, 0.0)):
        pos = workspaces.uniform_in_box(box, random_state)
        prop.set_pose(physics, position=pos, quaternion=quaternion)
        return pos

    def _arm_joint_ids(self, m):
        return [m.names.joint[f"{self._arm.name}/{j}"]
                for j in self._arm.joints]

    def _arm_joint_mid_values(self, m):
        """Per-joint home angle, as Python floats: mid-range for limited
        joints, 0 for unlimited (the Jaco's joint_2/joint_3 ranges exclude
        0)."""
        def build():
            mids = []
            for j in self._arm_joint_ids(m):
                lo, hi = m.jnt_range[j].cpu().tolist()
                mids.append(0.5 * (lo + hi) if m.jnt_limited[j] else 0.0)
            return mids
        return m.cached(("arm_mid_values", self._arm.name), build)

    def _randomize_arm(self, physics, random_state):
        """Perturbs arm joint angles around the home pose (reference
        initializers/ToolCenterPointInitializer samples TCP poses; here
        joints start near mid-range instead)."""
        mids = np.asarray(self._arm_joint_mid_values(physics.model))
        angles = mids + random_state.uniform(-0.2, 0.2,
                                             len(self._arm.joints))
        self._arm.set_joint_angles(physics, angles)

    def initialize_episode(self, physics, random_state):
        self._randomize_arm(physics, random_state)

    # -- batched helpers ------------------------------------------------------

    def _arm_joint_mids(self, m):
        """Per-joint home angle (nj,) in the model's dtype on its device."""
        return m.const(("arm_mids", self._arm.name),
                       self._arm_joint_mid_values(m))

    def _arm_qpos_addrs(self, m):
        return m.cached(("arm_qpos", self._arm.name), lambda: m.idx(
            [m.jnt_qposadr[j] for j in self._arm_joint_ids(m)]))

    def _arm_dof_addrs(self, m):
        return m.cached(("arm_dof", self._arm.name), lambda: m.idx(
            [m.jnt_dofadr[j] for j in self._arm_joint_ids(m)]))

    def _pinch_site_id(self, m):
        name = self._pinch_site_name()
        return m.cached(("site", name), lambda: m.names.site[name])

    def _free_joint(self, m, entity):
        """(qpos_adr, body_id) of a free entity's root joint (named
        '<frame>_root' by ``Arena.add_free_entity``)."""
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
