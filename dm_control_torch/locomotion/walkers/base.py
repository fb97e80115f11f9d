"""Walker entity base classes (counterpart of
``dm_control_tpu/locomotion/walkers/base.py``).

Reference: dm_control/locomotion/walkers/base.py:68-199 (egocentric-frame
transforms and ``WalkerObservables``) and legacy_base.py:31 (end-effector
and sensor conventions).  A walker attached to an arena prefixes every
name of its model with its own (``walker/lfemur``); the reads below look
the prefixed names up in the compiled model and copy from the physics'
device to the host.
"""

from __future__ import annotations

import abc

import numpy as np

from dm_control_torch import composer
from dm_control_torch.composer.observation.observable import Generic
from dm_control_torch.locomotion.walkers.initializers import UprightPose
from dm_control_torch.mjcf.element import Element


class Walker(composer.Entity):
    """A locomoting entity with a root body and egocentric transforms."""

    def _build_observables(self):
        return WalkerObservables(self)

    def create_root_joints(self, attachment_frame):
        """Adds root joints to the attachment frame (a free joint;
        BoxHead overrides it with planar slides)."""
        attachment_frame.children.insert(0, Element(
            "freejoint", {"name": attachment_frame.get("name") + "_root"},
            parent=attachment_frame))

    @property
    @abc.abstractmethod
    def root_body_name(self) -> str:
        """Name of the root body in the walker's own model."""

    def _prefixed(self, name: str) -> str:
        return f"{self.name}/{name}"

    def root_xmat(self, physics):
        return np.asarray(physics.named_field(
            "xmat", self._prefixed(self.root_body_name))).reshape(3, 3)

    def root_xpos(self, physics):
        return np.asarray(physics.named_field(
            "xpos", self._prefixed(self.root_body_name)))

    @property
    def upright_pose(self):
        """(qpos, xpos, xquat) for ``UprightInitializer``; None entries
        keep the model's default."""
        return UprightPose(qpos=None, xpos=None, xquat=None)

    def root_linear_velocity(self, physics):
        """World-frame linear velocity of the root: its free joint's, or
        the ``root_x``/``root_y``/``root_z`` slides' (BoxHead)."""
        m = physics.model
        frame = self.attachment_frame.get("name") if \
            self.attachment_frame is not None else self.name
        qvel = physics.data.qvel
        jname = f"{frame}_root"
        if jname in m.names.joint:
            a = int(m.jnt_dofadr[m.names.joint[jname]])
            return qvel[a:a + 3].cpu().numpy()
        addrs = [int(m.jnt_dofadr[m.names.joint[f"{self.name}/root_{ax}"]])
                 if f"{self.name}/root_{ax}" in m.names.joint else None
                 for ax in ("x", "y", "z")]
        out = np.zeros(3)
        found = [i for i, a in enumerate(addrs) if a is not None]
        if found:
            out[found] = qvel[[addrs[i] for i in found]].cpu().numpy()
        return out

    def reinitialize_pose(self, physics, random_state):
        """Restores an upright orientation at the present position."""
        del random_state
        pos, _ = self.get_pose(physics)
        try:
            self.set_pose(physics, np.asarray(pos), [1.0, 0.0, 0.0, 0.0])
        except ValueError:
            self.set_pose(physics, np.asarray(pos))

    def transform_vec_to_egocentric_frame(self, physics, vec_in_world):
        """World vector -> walker root frame
        (reference walkers/base.py:77)."""
        return np.asarray(vec_in_world) @ self.root_xmat(physics)

    def transform_xmat_to_egocentric_frame(self, physics, xmat):
        return self.root_xmat(physics).T @ np.asarray(xmat)

    def global_vector_to_local_frame(self, physics, vec_in_world):
        return self.transform_vec_to_egocentric_frame(physics, vec_in_world)

    def apply_action(self, physics, action, random_state):
        """Routes a policy action to the walker's actuators."""
        del random_state
        physics.set_control(action)

    @property
    def action_spec_shape(self):
        return None  # from the compiled model's actuators

    @property
    def end_effector_body_names(self):
        return ()

    @property
    def observable_joint_names(self):
        """The joints (in the walker's model) exposed as proprioception,
        in order."""
        return ()


class WalkerObservables(composer.Observables):
    """Proprioceptive observables (reference walkers/base.py:155-199)."""

    def _build(self):
        super()._build()
        walker = self._entity

        def joints_pos(physics):
            names = [walker._prefixed(j)
                     for j in walker.observable_joint_names]
            return np.asarray(
                [physics.named_field("qpos", n) for n in names])

        def joints_vel(physics):
            names = [walker._prefixed(j)
                     for j in walker.observable_joint_names]
            return np.asarray(
                [physics.named_field("qvel", n) for n in names])

        def world_zaxis(physics):
            # the root frame's third row: gravity's direction egocentrically
            return walker.root_xmat(physics)[2, :]

        def body_height(physics):
            return walker.root_xpos(physics)[2]

        def end_effectors_pos(physics):
            root_pos = walker.root_xpos(physics)
            root_mat = walker.root_xmat(physics)
            out = []
            for name in walker.end_effector_body_names:
                p = np.asarray(physics.named_field(
                    "xpos", walker._prefixed(name)))
                out.append((p - root_pos) @ root_mat)
            return np.hstack(out) if out else np.zeros(0)

        self.add_observable("joints_pos", Generic(joints_pos))
        self.add_observable("joints_vel", Generic(joints_vel))
        self.add_observable("world_zaxis", Generic(world_zaxis))
        self.add_observable("body_height", Generic(body_height))
        self.add_observable("end_effectors_pos", Generic(end_effectors_pos))

    @property
    def proprioception(self):
        return [self["joints_pos"], self["joints_vel"],
                self["body_height"], self["end_effectors_pos"]]

    @property
    def kinematic_sensors(self):
        return [self["world_zaxis"]]

    def enable_proprioception(self):
        for obs in self.proprioception + self.kinematic_sensors:
            obs.enabled = True
