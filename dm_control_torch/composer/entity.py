"""Entity: an attachable model component (counterpart of
``dm_control_tpu/composer/entity.py``).

Reference: dm_control/composer/entity.py:69-588 — entities construct an
MJCF submodel in ``_build``, expose observables via ``_build_observables``,
and are composed by ``attach``.  Here attachment is a compile-time element
tree merge with name prefixing (the analogue of PyMJCF's namescope
prefixing, dm_control/mjcf/element.py:693-770); after composition the whole
tree compiles once into a static Model.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional

import numpy as np

from dm_control_torch.composer.define import cached_property
from dm_control_torch.composer.define import observable as obs_deco
from dm_control_torch.composer.observation.observable import Observable
from dm_control_torch.mjcf.attachment import attach_model, detach_frame
from dm_control_torch.mjcf.element import Element


class Observables:
    """Container of an entity's observables
    (reference composer/entity.py:69)."""

    def __init__(self, entity):
        self._entity = entity
        self._observables: Dict[str, Observable] = {}
        self._build()

    def _build(self):
        """Collects @define.observable-decorated methods."""
        for name in dir(type(self)):
            attr = getattr(type(self), name, None)
            if isinstance(attr, obs_deco):
                self._observables[name] = attr.fget(self)

    def add_observable(self, name, observable):
        self._observables[name] = observable

    def as_dict(self, fully_qualified=True):
        prefix = (self._entity.name + "/") if (
            fully_qualified and self._entity.name) else ""
        return {prefix + k: v for k, v in self._observables.items()}

    def enable_all(self):
        for obs in self._observables.values():
            obs.enabled = True

    def disable_all(self):
        for obs in self._observables.values():
            obs.enabled = False

    def set_options(self, options):
        for name, opts in (options or {}).items():
            self._observables[name].configure(**opts)

    def __getattr__(self, name):
        try:
            return self.__dict__["_observables"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name):
        return self._observables[name]

    def keys(self):
        return self._observables.keys()


class Entity(abc.ABC):
    """Base entity (reference composer/entity.py:192)."""

    def __init__(self, *args, **kwargs):
        self._parent: Optional[Entity] = None
        self._attached: List[Entity] = []
        self._attachment_frame: Optional[Element] = None
        self._build(*args, **kwargs)

    @abc.abstractmethod
    def _build(self, *args, **kwargs):
        """Constructs self._mjcf_root (an Element tree)."""

    def _build_observables(self) -> Observables:
        return Observables(self)

    @cached_property
    def observables(self) -> Observables:
        return self._build_observables()

    @property
    def mjcf_model(self) -> Element:
        return self._mjcf_root

    @property
    def name(self) -> str:
        return self._mjcf_root.get("model", type(self).__name__.lower())

    @property
    def parent(self):
        return self._parent

    def iter_entities(self, exclude_self=False):
        if not exclude_self:
            yield self
        for child in self._attached:
            yield from child.iter_entities()

    # -- attachment ---------------------------------------------------------

    def attach(self, entity: "Entity",
               attach_site: Optional[Element] = None) -> Element:
        """Attaches ``entity``, returning its attachment frame body.

        The child's worldbody content is wrapped in a frame body at the
        attachment point; other sections merge into this model's tree with
        'childname/' name prefixing (PyMJCF semantics,
        dm_control/mjcf/element.py:893-952)."""
        prefix = entity.name + "/"
        # sites keep their reference pose semantics; bodies attach
        # directly underneath (attach_model handles both and the
        # namescope collision rejection)
        frame = attach_model(self._mjcf_root, entity.mjcf_model, prefix,
                             attach_site=attach_site)

        entity._parent = self
        entity._attachment_frame = frame
        self._attached.append(entity)
        return frame

    def detach(self):
        """Detaches this entity from its parent
        (reference entity.py:311)."""
        if self._parent is None:
            raise RuntimeError("Entity is not attached.")
        detach_frame(self._attachment_frame)
        self._parent._attached.remove(self)
        self._parent = None
        self._attachment_frame = None

    @property
    def attachment_frame(self) -> Optional[Element]:
        return self._attachment_frame

    # -- episode hooks (reference entity.py hooks) --------------------------

    def initialize_episode_mjcf(self, random_state):
        pass

    def initialize_episode(self, physics, random_state):
        pass

    def before_step(self, physics, random_state):
        pass

    def before_substep(self, physics, random_state):
        pass

    def after_substep(self, physics, random_state):
        pass

    def after_step(self, physics, random_state):
        pass

    # -- pose helpers (reference entity.py:409-570) -------------------------

    def set_pose(self, physics, position=None, quaternion=None):
        """Sets the entity's attachment-frame pose (requires a freejoint
        for moving entities)."""
        frame_name = self._attachment_frame.get("name")
        physics.set_body_pose(frame_name, position, quaternion)

    def get_pose(self, physics):
        frame_name = self._attachment_frame.get("name")
        return physics.body_pose(frame_name)

    def set_velocity(self, physics, velocity=None, angular_velocity=None):
        """Sets the entity's free-joint velocity
        (reference entity.py:505-540)."""
        frame_name = self._attachment_frame.get("name")
        physics.set_body_velocity(frame_name, velocity, angular_velocity)

    def shift_pose(self, physics, position=None, quaternion=None,
                   rotate_velocity=False):
        """Shifts the pose: position adds, quaternion pre-multiplies
        (reference entity.py:466-504)."""
        del rotate_velocity  # velocities are zeroed by soccer initializers
        cur_pos, cur_quat = self.get_pose(physics)
        new_pos = None if position is None else (
            np.asarray(cur_pos) + np.asarray(position))
        new_quat = None
        if quaternion is not None:
            q = np.asarray(quaternion, float)
            c = np.asarray(cur_quat, float)
            # Hamilton product q * c
            w0, x0, y0, z0 = q
            w1, x1, y1, z1 = c
            new_quat = np.array([
                w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
                w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
                w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
                w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1])
        self.set_pose(physics, new_pos, new_quat)


class ModelWrapperEntity(Entity):
    """Wraps a pre-built element tree (reference entity.py:588)."""

    def _build(self, mjcf_model: Element):
        self._mjcf_root = mjcf_model


class Robot(Entity):
    """Base class for robot entities (reference composer/robot.py)."""

    @property
    def actuators(self):
        section = self._mjcf_root.first("actuator")
        return tuple(section.children) if section is not None else ()
