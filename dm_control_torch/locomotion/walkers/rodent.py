"""Rodent walker (reference: dm_control/locomotion/walkers/rodent.py:60).

The full-fidelity rat: the model literal in locomotion/models/rodent.py
is a complete transcription of the reference's assets/rodent.xml
(67 joints, 38 actuators, 100 geoms, vertebral tendon columns, touch/
gyro/accelerometer sensors).  Only the rendering-only ``.skn`` skin is
dropped.

Counterpart of ``dm_control_tpu/locomotion/walkers/rodent.py``.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.locomotion.walkers import base
from dm_control_torch.suite._modelgen import to_element

#: mocap joint order (reference rodent.py:31-56 _RAT_MOCAP_JOINTS)
RAT_MOCAP_JOINTS = (
    "vertebra_1_extend", "vertebra_2_bend", "vertebra_3_twist",
    "vertebra_4_extend", "vertebra_5_bend", "vertebra_6_twist",
    "hip_L_supinate", "hip_L_abduct", "hip_L_extend", "knee_L", "ankle_L",
    "toe_L", "hip_R_supinate", "hip_R_abduct", "hip_R_extend", "knee_R",
    "ankle_R", "toe_R", "vertebra_C1_extend", "vertebra_C1_bend",
    "vertebra_C2_extend", "vertebra_C2_bend", "vertebra_C3_extend",
    "vertebra_C3_bend", "vertebra_C4_extend", "vertebra_C4_bend",
    "vertebra_C5_extend", "vertebra_C5_bend", "vertebra_C6_extend",
    "vertebra_C6_bend", "vertebra_C7_extend", "vertebra_C9_bend",
    "vertebra_C11_extend", "vertebra_C13_bend", "vertebra_C15_extend",
    "vertebra_C17_bend", "vertebra_C19_extend", "vertebra_C21_bend",
    "vertebra_C23_extend", "vertebra_C25_bend", "vertebra_C27_extend",
    "vertebra_C29_bend", "vertebra_cervical_5_extend",
    "vertebra_cervical_4_bend", "vertebra_cervical_3_twist",
    "vertebra_cervical_2_extend", "vertebra_cervical_1_bend",
    "vertebra_axis_twist", "vertebra_atlant_extend", "atlas", "mandible",
    "scapula_L_supinate", "scapula_L_abduct", "scapula_L_extend",
    "shoulder_L", "shoulder_sup_L", "elbow_L", "wrist_L", "finger_L",
    "scapula_R_supinate", "scapula_R_abduct", "scapula_R_extend",
    "shoulder_R", "shoulder_sup_R", "elbow_R", "wrist_R", "finger_R",
)

_STAND_HEIGHT = 0.077  # reference rodent tasks' stand height


class Rat(base.Walker):
    """The position-controlled rat with control range scaled to [-1, 1]
    (reference rodent.py:60-112)."""

    def _build(self, name="walker", torque_actuators=False,
               foot_mods=False):
        from dm_control_torch.locomotion.models.rodent import MODEL

        self._mjcf_root = to_element(MODEL)
        self._mjcf_root.attrib["model"] = name

        if torque_actuators:
            # reference rodent.py:79-84: gain = forcerange upper bound,
            # bias removed -> direct torque control
            for act in self._mjcf_root.find_all("general"):
                fr = act.get("forcerange")
                if fr is not None:
                    hi = str(fr).split()[-1]
                    act.attrib["gainprm"] = hi
                act.attrib["biastype"] = None
                act.attrib["biasprm"] = None

        if foot_mods:
            # reference rodent.py:86-89: widen ankle/toe ranges
            for dcls in self._mjcf_root.find_all("default"):
                if dcls.get("class") == "ankle":
                    j = dcls.first("joint")
                    if j is not None:
                        j.attrib["range"] = "-0.1 2.0"
                elif dcls.get("class") == "toe":
                    j = dcls.first("joint")
                    if j is not None:
                        j.attrib["range"] = "-0.7 0.87"

        self._joint_actuator_names = tuple(
            e.get("joint") for e in self._mjcf_root.find_all("general")
            if e.get("joint"))
        self._tendon_actuator_names = tuple(
            e.get("tendon") for e in self._mjcf_root.find_all("general")
            if e.get("tendon"))

    # -- body plan (reference rodent.py:95-152) -------------------------------

    @property
    def root_body_name(self):
        return "torso"

    @property
    def pelvis_body_name(self):
        return "pelvis"

    @property
    def head_body_name(self):
        return "skull"

    @property
    def left_arm_root_name(self):
        return "scapula_L"

    @property
    def right_arm_root_name(self):
        return "scapula_R"

    @property
    def standing_height(self):
        return _STAND_HEIGHT

    @property
    def end_effector_body_names(self):
        # reference rodent.py:146-152
        return ("lower_arm_R", "lower_arm_L", "foot_R", "foot_L")

    @property
    def ground_contact_geom_names(self):
        """Geoms of the feet/hands/head vertebra (reference
        rodent.py:130-139)."""
        out = []
        for bname in ("foot_L", "foot_R", "hand_L", "hand_R",
                      "vertebra_C1"):
            body = self._mjcf_root.find("body", bname)
            if body is not None:
                for e in body.iter():
                    if e.tag == "geom" and e.get("name"):
                        out.append(e.get("name"))
        return tuple(out)

    @property
    def observable_joint_names(self):
        """Joints driven by joint actuators, in actuator order
        (reference rodent.py:154-158)."""
        return self._joint_actuator_names

    @property
    def observable_tendon_names(self):
        return self._tendon_actuator_names

    @property
    def mocap_joint_names(self):
        return RAT_MOCAP_JOINTS

    @property
    def body_names(self):
        return tuple(e.get("name") for e in self._mjcf_root.iter()
                     if e.tag == "body" and e.get("name"))

    @property
    def mocap_tracking_body_names(self):
        """Bodies tracked by mocap (reference rodent.py:179-183: all
        bodies except vertebra/hand/toe detail bodies)."""
        import re

        return tuple(b for b in self.body_names
                     if not re.match(r"(vertebra_C|hand|toe)", b))

    @property
    def egocentric_camera_name(self):
        return "egocentric"

    def pose_to_actuation(self, pose):
        """Maps a mocap joint pose to position-actuator controls scaled
        to [-1, 1] (reference rodent.py:239-256)."""
        return np.clip(np.asarray(pose, float), -1.0, 1.0)

    def aliveness(self, physics):
        """0 when upright, approaching -1 when flipped (reference
        legacy_base aliveness via torso z-axis)."""
        zz = float(np.asarray(self.root_xmat(physics))[2, 2])
        return (zz - 1.0) / 2.0
