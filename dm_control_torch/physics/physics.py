"""Stateful Physics facade: the analogue of mujoco.Physics.

Counterpart of ``dm_control_tpu/physics/physics.py`` (reference:
dm_control/mujoco/engine.py:86-592): step, forward, reset, state get and
set, named indexing.  It holds a Model and the Data of one environment
(B = 1) on the model's device and runs the batched ``engine`` on them;
``data`` presents that Data without its batch axis, as views.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from dm_control_torch.physics import engine
from dm_control_torch.physics.index import JOINT_WIDTHS
from dm_control_torch.physics.model import (
    Data, JointType, Model, env_view, make_data, map_tensors,
)
from dm_control_torch.rl import control as rl_control

# Data/Model field -> name namespace and address resolution.
_FIELD_NAMESPACES = {
    "qpos": ("joint", "qpos"),
    "qvel": ("joint", "dof"),
    "qfrc_applied": ("joint", "dof"),
    "xpos": ("body", None),
    "xquat": ("body", None),
    "xmat": ("body", None),
    "xipos": ("body", None),
    "subtree_com": ("body", None),
    "geom_xpos": ("geom", None),
    "geom_xmat": ("geom", None),
    "site_xpos": ("site", None),
    "site_xmat": ("site", None),
    "ctrl": ("actuator", None),
    "actuator_force": ("actuator", None),
    "sensordata": ("sensor", "sensor"),
    "ten_length": ("tendon", None),
}


class PhysicsError(RuntimeError):
    """Physics diverged (reference rl/control.py:264)."""


class Physics:
    """Holds a Model and the Data of one environment."""

    def __init__(self, model: Model, data: Optional[Data] = None):
        """``data``, where given, is a Data of one environment (B = 1)."""
        self._model = model
        self._data = data if data is not None else make_data(model, 1)
        self._dirty = False

    # -- dirty/lazy-forward protocol (reference mjcf/physics.py:536-545) ----

    @property
    def is_dirty(self) -> bool:
        return self._dirty

    def mark_as_dirty(self) -> None:
        """State or model was written: derived quantities are stale until
        the next forward()."""
        self._dirty = True

    def _ensure_clean(self) -> None:
        if self._dirty:
            self.forward()

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_model(cls, model: Model) -> "Physics":
        return cls(model)

    @classmethod
    def from_xml_string(cls, xml: str, assets=None, *, device=None,
                        dtype: torch.dtype = torch.float64) -> "Physics":
        """Parses and compiles MJCF XML onto ``device`` (the card unless
        the caller asks for another) in ``dtype``."""
        from dm_control_torch import mjcf

        return cls(mjcf.compile_xml_string(xml, assets=assets, device=device,
                                           dtype=dtype))

    @classmethod
    def from_mjcf_model(cls, element, *, device=None,
                        dtype: torch.dtype = torch.float64) -> "Physics":
        """Compiles an MJCF element tree onto ``device`` (the card unless
        the caller asks for another) in ``dtype``."""
        from dm_control_torch.mjcf.compiler import compile_model

        return cls(compile_model(element, device=device, dtype=dtype))

    # -- core ---------------------------------------------------------------

    @property
    def model(self) -> Model:
        return self._model

    @property
    def data(self) -> Data:
        """The Data without its batch axis (views of the state)."""
        return env_view(self._data)

    def step(self, n_steps: int = 1):
        for _ in range(n_steps):
            self._data = engine.step(self._model, self._data)
        if bool(engine.check_divergence(self._model, self._data)[0]):
            raise PhysicsError("Physics state is invalid (divergence).")

    def forward(self):
        self._data = engine.forward(self._model, self._data)
        self._dirty = False

    def after_reset(self):
        """The forward after a state write (engine.py:268-295)."""
        self.forward()

    def render(self, height: int = 240, width: int = 320, camera_id=-1,
               overlays=(), depth: bool = False, segmentation: bool = False,
               scene_option=None, render_flag_overrides=None,
               scene_callback=None):
        """Ray-cast render on the model's device (reference Physics.render,
        engine.py:168-217): uint8 (H, W, 3) RGB, float32 (H, W) plane depth
        in meters, or int32 (H, W, 2) [objid, objtype] segmentation, as
        numpy."""
        from dm_control_torch import rendering

        return rendering.render(
            self, height=height, width=width, camera_id=camera_id,
            depth=depth, segmentation=segmentation)

    def reset(self):
        self._data = make_data(self._model, 1)
        self.forward()

    @contextlib.contextmanager
    def reset_context(self):
        """Reference pattern: mutate state inside, forward on exit
        (rl/control.py:226-247)."""
        self._data = make_data(self._model, 1)
        yield self
        self.forward()

    def copy(self, share_model: bool = True):
        """A Physics with the same model and a copy of the state."""
        del share_model  # the model is never written in place
        copied = Physics(self._model, map_tensors(self._data, torch.clone))
        copied._dirty = self._dirty
        return copied

    # -- state --------------------------------------------------------------

    def time(self) -> float:
        return float(self._data.time[0])

    def get_state(self) -> np.ndarray:
        """[qpos, qvel, act] (reference engine.py:217-245)."""
        d = self._data
        return torch.cat([d.qpos[0], d.qvel[0], d.act[0]]).cpu().numpy()

    def set_state(self, physics_state):
        m = self._model
        state = torch.as_tensor(np.asarray(physics_state), dtype=m.dtype,
                                device=m.device).reshape(1, -1)
        self._data = self._data.replace(
            qpos=state[:, :m.nq], qvel=state[:, m.nq:m.nq + m.nv],
            act=state[:, m.nq + m.nv:])
        self.mark_as_dirty()

    def set_data(self, **fields):
        """Replaces Data fields of the environment (``qpos=...``, given
        without the batch axis) with host values, as they stood after a
        step of another run of the same model.  Neither forward nor the
        dirty flag: the next ``step`` recomputes what derives from them
        (a recorded episode replayed one control step at a time,
        ``rl/golden.py``)."""
        m = self._model
        self._data = self._data.replace(**{
            k: torch.as_tensor(np.asarray(v), dtype=getattr(
                self._data, k).dtype, device=m.device).reshape(
                    getattr(self._data, k).shape)
            for k, v in fields.items()})

    def set_entries(self, field: str, addrs, values):
        """Writes host ``values`` into entries ``addrs`` of the
        environment's Data field ``field`` (``qpos``, ``qvel``), in the
        field's type on its device.  Neither forward nor the dirty flag:
        the caller marks the physics dirty where the JAX package's hook
        does."""
        t = getattr(self._data, field).clone()
        t[0, list(addrs)] = torch.as_tensor(
            np.asarray(values, dtype=float).ravel(), dtype=t.dtype,
            device=t.device)
        self._data = self._data.replace(**{field: t})

    def set_control(self, action):
        m = self._model
        self._data = self._data.replace(ctrl=torch.as_tensor(
            np.asarray(action), dtype=m.dtype, device=m.device).reshape(
                1, m.nu))

    def position(self):
        return self._data.qpos[0].cpu().numpy()

    def velocity(self):
        return self._data.qvel[0].cpu().numpy()

    def control(self):
        return self._data.ctrl[0].cpu().numpy()

    def activation(self):
        return self._data.act[0].cpu().numpy()

    def action_spec(self):
        return rl_control.action_spec(self._model)

    # -- named access -------------------------------------------------------

    @property
    def named(self):
        """``physics.named.data.qpos['hinge']``-style FieldIndexer views
        incl. ragged axes and named columns (reference mujoco/index.py)."""
        from dm_control_torch.physics.index import Named

        return Named(self)

    def named_field(self, kind: str, names):
        """Named numpy view into a Data/Model field (the analogue of
        physics.named.data.<field>[names], dm_control/mujoco/index.py:436).
        """
        m = self._model
        if callable(names):
            return names(self)
        data = self.data
        source = data if hasattr(data, kind) else m
        field = getattr(source, kind).detach().cpu().numpy()
        namespace, addr = _FIELD_NAMESPACES.get(kind, (None, None))
        if namespace is None:
            raise KeyError(f"No named view for field {kind!r}")
        single = isinstance(names, str)
        rows = []
        for name in [names] if single else list(names):
            idx = getattr(m.names, namespace)[name]
            if addr in ("qpos", "dof"):
                a = m.jnt_qposadr[idx] if addr == "qpos" else \
                    m.jnt_dofadr[idx]
                w = JOINT_WIDTHS[m.jnt_type[idx]][addr == "dof"]
                rows.append(field[a:a + w] if w > 1 else field[a])
            elif addr == "sensor":
                a, dim = m.sensor_adr[idx], m.sensor_dim[idx]
                rows.append(field[a:a + dim])
            else:
                rows.append(field[idx])
        if single:
            return np.asarray(rows[0])
        if all(np.shape(r) == np.shape(rows[0]) for r in rows):
            return np.stack([np.atleast_1d(r) for r in rows])
        return [np.asarray(r) for r in rows]

    # -- body pose helpers (composer entities) ------------------------------

    def body_pose(self, body_name: str):
        self._ensure_clean()
        b = self._model.names.body[body_name]
        return (self._data.xpos[0, b].cpu().numpy(),
                self._data.xquat[0, b].cpu().numpy())

    def _free_joint(self, body_name: str, what: str) -> int:
        m = self._model
        jadr = m.body_jntadr[m.names.body[body_name]]
        if jadr < 0 or m.jnt_type[jadr] != int(JointType.FREE):
            raise ValueError(
                f"Body {body_name!r} has no free joint; cannot set {what}.")
        return jadr

    def _vector(self, value, n):
        m = self._model
        return torch.as_tensor(np.asarray(value), dtype=m.dtype,
                               device=m.device).expand(n)

    def set_body_pose(self, body_name: str, position=None, quaternion=None):
        """Writes a free body's pose into qpos (the body must have a free
        joint)."""
        qadr = self._model.jnt_qposadr[self._free_joint(body_name, "pose")]
        qpos = self._data.qpos.clone()
        if position is not None:
            qpos[0, qadr:qadr + 3] = self._vector(position, 3)
        if quaternion is not None:
            qpos[0, qadr + 3:qadr + 7] = self._vector(quaternion, 4)
        self._data = self._data.replace(qpos=qpos)
        self.mark_as_dirty()

    def set_body_velocity(self, body_name: str, velocity=None,
                          angular_velocity=None):
        """Writes a free body's linear/angular velocity into qvel
        (reference composer/entity.py set_velocity free-joint branch)."""
        dadr = self._model.jnt_dofadr[self._free_joint(body_name,
                                                       "velocity")]
        qvel = self._data.qvel.clone()
        if velocity is not None:
            qvel[0, dadr:dadr + 3] = self._vector(velocity, 3)
        if angular_velocity is not None:
            qvel[0, dadr + 3:dadr + 6] = self._vector(angular_velocity, 3)
        self._data = self._data.replace(qvel=qvel)
        self.mark_as_dirty()

    def bind(self, elements):
        """A read/write attribute Binding for MJCF element(s) (reference
        mjcf/physics.py:560): ``physics.bind(geom).xpos``,
        ``physics.bind(joint).qpos = ...`` with the dirty/lazy-forward
        protocol.  Accepts Elements or name strings (treated as bodies)."""
        from dm_control_torch.mjcf.physics import bind as _bind

        return _bind(self, elements)

    def bind_id(self, element_or_name, kind: str = "body"):
        """The raw id of a named element for array indexing."""
        name = element_or_name if isinstance(element_or_name, str) \
            else element_or_name.get("name")
        return getattr(self._model.names, kind)[name]
