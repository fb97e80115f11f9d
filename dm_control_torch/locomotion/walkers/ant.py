"""The ant walker (counterpart of
``dm_control_tpu/locomotion/walkers/ant.py``; reference:
dm_control/locomotion/walkers/ant.py:31, model from
third_party/ant/ant.xml).

A four-legged torso on a free root with eight hinges; its touch,
velocimeter, gyro, accelerometer and rangefinder sensors come with the
model literal (``models/ant.py``).
"""

from __future__ import annotations

from dm_control_torch.locomotion.models.ant import MODEL
from dm_control_torch.locomotion.walkers import base
from dm_control_torch.suite._modelgen import to_element


class Ant(base.Walker):
    """A quadruped ant."""

    def _build(self, name="ant", marker_rgba=None):
        self._mjcf_root = to_element(MODEL)
        self._mjcf_root.attrib["model"] = name
        if marker_rgba is not None:
            rgba = " ".join(str(v) for v in marker_rgba)
            for geom in self._mjcf_root.find_all("geom"):
                geom.attrib["rgba"] = rgba

    @property
    def root_body_name(self):
        return "torso"

    @property
    def end_effector_body_names(self):
        """The bodies named with "ankle", as in the JAX package: none, since
        the model's lowest leg segments are the "*_foot" bodies."""
        return tuple(e.get("name") for e in self._mjcf_root.iter()
                     if e.tag == "body" and e.get("name")
                     and "ankle" in e.get("name"))

    @property
    def observable_joint_names(self):
        return tuple(e.get("name") for e in self._mjcf_root.iter()
                     if e.tag == "joint" and e.get("name"))
