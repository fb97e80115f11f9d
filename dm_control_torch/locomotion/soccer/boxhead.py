"""The BoxHead soccer walker (counterpart of
``dm_control_tpu/locomotion/soccer/boxhead.py``; reference:
dm_control/locomotion/soccer/boxhead.py, model from
soccer/assets/boxhead/boxhead.xml).

A wheeled robot on three slide joints (``root_x``, ``root_y``,
``root_z``) that turns on its ``steer`` hinge, with a kick and a roll
joint; in a compiled match every name is prefixed with the walker's
(``home0/steer``).
"""

from __future__ import annotations

from dm_control_torch.locomotion.models.boxhead import MODEL
from dm_control_torch.locomotion.walkers import base
from dm_control_torch.mjcf.element import Element
from dm_control_torch.suite._modelgen import to_element


class BoxHead(base.Walker):
    """A wheeled box-headed robot with steer, roll and kick actuators."""

    def _build(self, name="boxhead", walker_id=None, marker_rgba=None):
        self._walker_id = walker_id
        self._mjcf_root = to_element(MODEL)
        self._mjcf_root.attrib["model"] = name
        if marker_rgba is not None:
            rgba = " ".join(str(v) for v in marker_rgba)
            for geom in self._mjcf_root.find_all("geom"):
                geom.attrib["rgba"] = rgba

    @property
    def walker_id(self):
        return self._walker_id

    def create_root_joints(self, attachment_frame):
        """Three slide joints (reference soccer/boxhead.py:258-266), each
        put first in the frame, so they stand in the order z, y, x: yaw
        comes from the steer joint, and a free joint would make the mass
        matrix singular."""
        for name, axis in (("root_x", "1 0 0"), ("root_y", "0 1 0"),
                           ("root_z", "0 0 1")):
            attachment_frame.children.insert(0, Element(
                "joint", {"name": f"{self.name}/{name}", "type": "slide",
                          "axis": axis}, parent=attachment_frame))

    def set_pose(self, physics, position=None, quaternion=None):
        """Writes ``position`` into the three slides' qpos; the
        orientation comes from the steer joint, so ``quaternion`` is
        ignored.  As in the JAX package, the physics is not marked
        dirty: the poses read next are those of the last forward."""
        del quaternion
        if position is None:
            return
        m = physics.model
        addrs = [int(m.jnt_qposadr[m.names.joint[f"{self.name}/{name}"]])
                 for name in ("root_x", "root_y", "root_z")]
        physics.set_entries("qpos", addrs,
                            [float(position[i]) for i in range(3)])

    @property
    def root_body_name(self):
        return "head_body"

    @property
    def observable_joint_names(self):
        return ("steer", "kick", "roll")
