"""CMU humanoid walkers (counterpart of
``dm_control_tpu/locomotion/walkers/cmu_humanoid.py``; reference:
dm_control/locomotion/walkers/cmu_humanoid.py:183-422).

``CMUHumanoid`` is the torque-actuated 2019 humanoid, built from the
literal tree of ``models/humanoid_cmu_v2019.py``.
``CMUHumanoidPositionControlled`` replaces every motor by a ``general``
actuator with an affine bias mapping a control in [-1, 1] onto its
joint's range (gainprm [kp * slope], biasprm [kp * (lo + slope), -kp,
0]), with the reference's per-joint kp and force range
(``cmu_actuator_params.py``, transcribed data).  The 2020 revision
(``CMUHumanoidPositionControlledV2020``) builds on the literal of
``models/humanoid_cmu_v2020.py`` with its own table, per-joint damping
and a 30 ms activation filter.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.locomotion.models.humanoid_cmu_v2019 import (
    MODEL as MODEL_2019,
)
from dm_control_torch.locomotion.models.humanoid_cmu_v2020 import (
    MODEL as MODEL_2020,
)
from dm_control_torch.locomotion.walkers import base, cmu_actuator_params
from dm_control_torch.suite._modelgen import to_element

_POSITION_ACTUATOR_KP = 300.0


class CMUHumanoid(base.Walker):
    """Torque-actuated CMU humanoid
    (model: reference walkers/assets/humanoid_CMU_V2019.xml)."""

    _MODEL = MODEL_2019

    def _build(self, name="walker"):
        self._mjcf_root = to_element(self._MODEL)
        self._mjcf_root.attrib["model"] = name

    @property
    def root_body_name(self):
        for e in self._mjcf_root.first("worldbody").iter():
            if e.tag == "body":
                return e.get("name")
        raise ValueError("no root body")

    @property
    def observable_joint_names(self):
        return tuple(e.get("name") for e in self._mjcf_root.iter()
                     if e.tag == "joint" and e.get("name")
                     and e.get("type") != "free")

    @property
    def end_effector_body_names(self):
        # the reference's end_effectors, in its order
        # (cmu_humanoid.py:313-317) — mocap clip end_effectors/appendages
        # features are laid out against exactly this sequence
        return ("rradius", "lradius", "rfoot", "lfoot")

    @property
    def mocap_tracking_body_names(self):
        """Bodies the mocap pipeline tracks, in the reference's order
        (cmu_humanoid.py mocap_tracking_bodies): every body except the
        root — clip body_positions/body_quaternions columns align to
        this sequence."""
        names = [e.get("name") for e in self._mjcf_root.iter()
                 if e.tag == "body" and e.get("name")]
        return tuple(n for n in names if n != self.root_body_name)

    @property
    def mocap_joint_names(self):
        return self.observable_joint_names


class CMUHumanoidPositionControlled(CMUHumanoid):
    """Position-actuated variant with [-1, 1] scaled controls.

    Mirrors the reference exactly (cmu_humanoid.py:358-421 +
    scaled_actuators.add_position_actuator): every motor is replaced by
    a `general` actuator with an affine bias pre-mapping ctrl in [-1, 1]
    onto the joint's range — gainprm [kp*slope], biasprm
    [kp*(lo - slope*(-1)), -kp, 0] — with the reference's tuned per-joint
    kp / forcerange (cmu_actuator_params.py, transcribed data); the 2020
    revision additionally sets per-joint damping and a 30 ms activation
    filter.  The gains are written with 17 digits, as the JAX package's
    humanoid writes them, not through ``scaled_actuators`` (``%g``), so the
    compiled model is the JAX compiler's bit for bit."""

    _ACTUATOR_TABLE = "POSITION_ACTUATORS"
    _FILTER = None

    def _build(self, name="walker"):
        super()._build(name=name)
        params = getattr(cmu_actuator_params, self._ACTUATOR_TABLE)
        actuator_sec = self._mjcf_root.first("actuator")
        if actuator_sec is None:
            actuator_sec = self._mjcf_root.add("actuator")
        actuator_sec.children.clear()
        joints = {e.get("name"): e for e in self._mjcf_root.iter()
                  if e.tag == "joint" and e.get("name")}
        lowers, uppers = [], []
        for row in params:
            jname, forcerange, kp = row[0], row[1], row[2]
            joint = joints[jname]
            if len(row) > 3:  # the 2020 per-joint damping
                joint.attrib["damping"] = f"{row[3]:g}"
            lo, hi = [float(x) for x in str(joint.get("range")).split()]
            lowers.append(lo)
            uppers.append(hi)
            slope = (hi - lo) / 2.0  # ctrlrange (-1, 1)
            kwargs = dict(
                name=jname, joint=jname, biastype="affine",
                gainprm=f"{kp * slope:.17g}",
                biasprm=f"{kp * (lo + slope):.17g} {-kp:.17g} 0",
                ctrllimited="true", ctrlrange="-1 1",
                forcelimited="true",
                forcerange=f"{forcerange[0]:g} {forcerange[1]:g}")
            if self._FILTER:
                kwargs["dyntype"] = "filter"
                kwargs["dynprm"] = f"{self._FILTER:g}"
            actuator_sec.add("general", **kwargs)
        upper, lower = np.asarray(uppers), np.asarray(lowers)
        self._scale = upper - lower
        self._offset = upper + lower
        self._actuator_order = np.argsort(
            cmu_actuator_params.CMU_MOCAP_JOINTS)

    @property
    def actuator_order(self):
        return self._actuator_order

    def cmu_pose_to_actuation(self, target_pose):
        """Control signal reaching a CMU mocap joint pose (reference
        cmu_humanoid.py:406-421): inverse of the actuators' affine
        [-1, 1] -> joint-range map, in canonical CMU joint order."""
        target_pose = np.asarray(target_pose)
        return (2 * target_pose[self._actuator_order]
                - self._offset) / self._scale


class CMUHumanoidPositionControlledV2020(CMUHumanoidPositionControlled):
    """The 2020 revision: retuned actuator tables, per-joint damping,
    and a 30 ms first-order activation filter."""

    _MODEL = MODEL_2020
    _ACTUATOR_TABLE = "POSITION_ACTUATORS_V2020"
    _FILTER = 0.030
