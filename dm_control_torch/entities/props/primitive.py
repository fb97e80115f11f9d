"""Primitive free-moving prop (counterpart of
``dm_control_tpu/entities/props/primitive.py``; reference:
dm_control/entities/props/primitive.py:109)."""

from __future__ import annotations

import numpy as np

from dm_control_torch import composer
from dm_control_torch.composer.observation.observable import Generic
from dm_control_torch.mjcf.element import Element


class Primitive(composer.Entity):
    """A single-geom prop (sphere/box/capsule/...)."""

    def _build(self, geom_type="sphere", size=(0.05,), mass=None,
               name="prop", **geom_kwargs):
        root = Element("mujoco", {"model": name})
        wb = root.add("worldbody")
        body = wb.add("body", name="body")
        kwargs = dict(name="geom", type=geom_type,
                      size=" ".join(str(s) for s in size), **geom_kwargs)
        if mass is not None:
            kwargs["mass"] = str(mass)
        self._geom = body.add("geom", **kwargs)
        self._mjcf_root = root

    @property
    def geom(self):
        return self._geom

    def _build_observables(self):
        obs = composer.Observables(self)
        obs.add_observable("position", Generic(
            lambda phys: np.asarray(phys.named_field(
                "xpos", self.attachment_frame.get("name")))))
        obs.add_observable("orientation", Generic(
            lambda phys: np.asarray(phys.named_field(
                "xquat", self.attachment_frame.get("name")))))
        return obs

    def position(self, physics):
        # reads through the PyMJCF binding layer (lazy-forward protocol)
        return np.asarray(physics.bind(self.attachment_frame).xpos)


class Brick(Primitive):
    """A plain stackable box brick.  The manipulation tasks use the real
    stud-coupling Duplo (entities/props/duplo); this cheaper primitive
    remains for custom tasks that don't need snap dynamics."""

    def _build(self, size=(0.04, 0.02, 0.015), mass=0.05, name="brick"):
        super()._build(geom_type="box", size=size, mass=mass, name=name,
                       friction="1.5 0.01 0.001", condim="4")
        self._half_height = size[2]

    @property
    def half_height(self):
        return self._half_height
