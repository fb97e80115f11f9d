"""Episode state, timestep payload, the task interface, and the
single-environment ``Environment``.

Counterpart of ``dm_control_tpu/rl/control.py``.  ``RandomContext``
draws either from a ``torch.Generator`` on the batch's device, one value
per environment for every logical draw a task makes (``BatchEnv``), or
from a ``numpy.random.RandomState`` in the reference's call order, for
one environment (``Environment``: the same episodes as the JAX package's
and the reference's under the same seed).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from dm_control_torch.physics import engine
from dm_control_torch.physics import sensors as sens
from dm_control_torch.physics.model import (
    Data, IntegratorType, Model, env_view, make_data,
)
from dm_control_torch.rl import environment, specs

FIRST = int(environment.StepType.FIRST)
MID = int(environment.StepType.MID)
LAST = int(environment.StepType.LAST)


@dataclasses.dataclass
class EnvState:
    """Episode state of B environments.  ``data`` carries only the true
    state fields between steps (see ``BatchEnv``)."""

    data: Data
    model_diff: Dict[str, Any]
    rng: torch.Generator  # draws the episode inits of autoresets
    step_count: torch.Tensor  # (B,) int32
    needs_reset: torch.Tensor  # (B,) bool

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass
class TimeStepData:
    """Batched dm_env.TimeStep payload."""

    step_type: torch.Tensor  # (B,) int32: FIRST/MID/LAST
    reward: torch.Tensor  # (B, *Task.reward_shape)
    discount: torch.Tensor  # (B,)
    observation: Any  # OrderedDict[str, (B, ...)]


class RandomContext:
    """Random draws for task inits, from one of two sources.

    With a ``torch.Generator`` (``RandomContext(generator, batch, dtype)``)
    every call returns a tensor with the batch ``B`` first.  With a numpy
    ``RandomState`` (``RandomContext.numpy``, ``is_numpy``) every call
    makes the same numpy call as the JAX package's numpy path, on the host
    in float64, and returns it as a (1, ...) tensor on ``device``: the
    draws, their order and their arithmetic (``low + (high - low) * u``)
    are the reference's, so a seed gives its episodes.
    """

    def __init__(self, generator: Optional[torch.Generator], batch: int,
                 dtype: torch.dtype, *,
                 np_random: Optional[np.random.RandomState] = None,
                 device=None):
        if (generator is None) == (np_random is None):
            raise ValueError("Provide exactly one of generator or "
                             "np_random.")
        self.generator = generator
        self.np_random = np_random
        self.batch = batch
        self.dtype = dtype
        self.device = (generator.device if generator is not None
                       else torch.device(device))

    @classmethod
    def numpy(cls, np_random: np.random.RandomState, device,
              dtype: torch.dtype) -> "RandomContext":
        """One environment's draws from ``np_random``."""
        return cls(None, 1, dtype, np_random=np_random, device=device)

    @property
    def is_numpy(self) -> bool:
        return self.np_random is not None

    def _host(self, value, dtype=None):
        """A numpy draw as a (1, ...) tensor on the device."""
        value = np.asarray(value)
        return torch.as_tensor(value).to(
            device=self.device, dtype=dtype or self.dtype).reshape(
                (1,) + value.shape)

    def rand(self, *size):
        """U[0, 1) of shape (B, *size)."""
        if self.is_numpy:
            return self._host(self.np_random.rand(*size))
        return torch.rand((self.batch, *size), generator=self.generator,
                          dtype=self.dtype, device=self.device)

    def randn(self, *size):
        """N(0, 1) of shape (B, *size)."""
        if self.is_numpy:
            return self._host(self.np_random.randn(*size))
        return torch.randn((self.batch, *size), generator=self.generator,
                           dtype=self.dtype, device=self.device)

    def uniform(self, low, high, *size):
        """U[low, high) of shape (B, *size); ``low`` and ``high`` are
        numbers or tensors that broadcast against ``size``."""
        if self.is_numpy:
            return self._host(self.np_random.uniform(
                _host_value(low), _host_value(high), size or None))
        return low + (high - low) * self.rand(*size)

    def randint(self, low, high, *size):
        """Integers uniform in [low, high) of shape (B, *size), int64."""
        if self.is_numpy:
            return self._host(self.np_random.randint(low, high, size or None),
                              torch.int64)
        return torch.randint(low, high, (self.batch, *size),
                             generator=self.generator, device=self.device)


def _host_value(x):
    """A number or a tensor as a float64 numpy value."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return x


class Task:
    """Functional task interface over batched (Model, Data)."""

    #: physics steps after init to settle the state
    settle_steps: int = 0
    #: re-draw the initial state while ``reject(m, d)`` holds
    max_reset_rejections: int = 0
    #: deepest pipeline stage observation/reward/termination read:
    #: "vel" (position and velocity stage) or "acc"
    observation_stages: str = "acc"
    #: shape of one environment's reward: () for a scalar, (n_players,)
    #: for a multi-agent task (soccer); the discount stays one per
    #: environment
    reward_shape: tuple = ()

    def init(self, m: Model, qpos, qvel, rc: RandomContext, diff: Dict):
        """Returns (qpos, qvel, diff) for new episodes, (B, ...)."""
        return qpos, qvel, diff

    def init_act(self, m: Model, rc: RandomContext):
        """Activations (B, na) for new episodes, drawn after ``init``, or
        None to leave them at 0."""
        return None

    def reject(self, m: Model, d: Data):
        return torch.zeros(d.qpos.shape[0], dtype=torch.bool,
                           device=d.qpos.device)

    def reject_reinit(self, m: Model, qpos, qvel, rc: RandomContext,
                      diff: Dict):
        """The draw after a rejected initial state in the single-environment
        reset: ``init`` unless the reference's rejection loop draws only
        part of the state again (finger draws its joints only)."""
        return self.init(m, qpos, qvel, rc, diff)

    def initial_model_diff(self, m: Model) -> Dict:
        return {}

    def observation(self, m: Model, d: Data):
        raise NotImplementedError

    def reward(self, m: Model, d: Data):
        raise NotImplementedError

    def termination(self, m: Model, d: Data):
        """Returns (terminate (B,) bool, discount_on_termination (B,))."""
        B = d.qpos.shape[0]
        return (torch.zeros(B, dtype=torch.bool, device=d.qpos.device),
                torch.ones(B, dtype=d.qpos.dtype, device=d.qpos.device))

    def before_step(self, m: Model, d: Data, action) -> Data:
        return d.replace(ctrl=torch.as_tensor(action, dtype=d.ctrl.dtype,
                                              device=d.ctrl.device))


#: Model fields a per-episode diff may override.  Each may carry a leading
#: batch axis (one value per environment), and the code that reads it
#: broadcasts over either shape: ``body_pos`` (nbody, 3), ``body_quat``
#: (nbody, 4), ``geom_pos`` and ``site_pos`` in ``kinematics.kinematics``;
#: ``wrap_prm`` (nwrap,) in ``kinematics.tendon``; ``hfield_data`` (nrow,
#: ncol) in ``collision._hf_surface`` (the one reader of the terrain: the
#: rangefinder does not see it); ``dof_damping`` (nv,) in
#: ``dynamics.passive`` and ``engine.euler`` (a batched one always takes
#: the implicit step, as a traced one does in the JAX package);
#: ``site_size`` (nsite, 3) in ``sensors._touch``, and in the tasks.  No
#: constant cached on the model derives from them, so the overridden model
#: shares the cache of the one it came from.
DIFF_FIELDS = frozenset({"geom_pos", "wrap_prm", "hfield_data", "body_pos",
                         "body_quat", "dof_damping", "site_pos",
                         "site_size"})


def apply_model_diff(m: Model, diff: Dict) -> Model:
    """Per-episode Model overrides; "_"-prefixed keys become
    ``m.task_state``."""
    if not diff:
        return m
    pub = {k: v for k, v in diff.items() if not k.startswith("_")}
    priv = {k: v for k, v in diff.items() if k.startswith("_")}
    if not DIFF_FIELDS.issuperset(pub):
        raise ValueError(f"model diff may override {sorted(DIFF_FIELDS)}, "
                         f"got {sorted(pub)}")
    if priv:
        pub["task_state"] = priv
    return m.replace_sharing_cache(**pub)


def compute_n_steps(control_timestep, physics_timestep, tolerance=1e-8):
    """Validated substep count (dm_control/rl/control.py:164-190)."""
    if control_timestep < physics_timestep:
        raise ValueError(
            f"Control timestep ({control_timestep}) cannot be smaller than "
            f"physics timestep ({physics_timestep}).")
    if abs((control_timestep / physics_timestep)
           - round(control_timestep / physics_timestep)) > tolerance:
        raise ValueError(
            "Control timestep must be an integer multiple of physics "
            "timestep.")
    return int(round(control_timestep / physics_timestep))



class Environment(environment.Environment):
    """One environment with the dm_env interface (the JAX package's
    ``rl/control.py::Environment``, the reference's
    ``control.Environment``): numpy actions in, numpy observations out,
    episode starts drawn on the host from a ``numpy.random.RandomState``
    in the reference's call order.

    The state is a Data of one environment (B = 1) on the model's device,
    stepped by the batched ``engine``; what the user sees has no batch
    axis.  Its semantics are the JAX single environment's, not
    ``BatchEnv``'s: a reset draws up to ``max_reset_rejections`` times
    (``init``, then ``reject_reinit``), each from a fresh Data; a settle
    loop under Euler starts with an Euler step over the forward of a
    pristine state with the drawn state grafted in; the reset's
    observation runs the whole pipeline with the actuator forces zeroed
    before the acceleration stage; a step refreshes the position and
    velocity stages and their sensors after its substeps, but not the
    acceleration-stage sensors; termination is read on the host.
    """

    def __init__(self, model: Model, task: Task,
                 time_limit: float = float("inf"),
                 control_timestep: Optional[float] = None,
                 random=None):
        self._model = model
        self._task = task
        if not isinstance(random, np.random.RandomState):
            random = np.random.RandomState(random)
        self._random = random
        self._physics_timestep = float(model.opt.timestep)
        if control_timestep is None:
            control_timestep = self._physics_timestep
        self._control_timestep = control_timestep
        # a float32 model rounds its timestep: a wider divisibility
        # tolerance there (float64 keeps the reference's 1e-8)
        tol = 1e-8 if model.dtype == torch.float64 else 1e-4
        self._n_sub_steps = compute_n_steps(control_timestep,
                                            self._physics_timestep,
                                            tolerance=tol)
        self._time_limit = time_limit
        if time_limit == float("inf"):
            self._step_limit = float("inf")
        else:
            self._step_limit = int(round(time_limit / control_timestep))
        self._step_count = 0
        self._data: Optional[Data] = None
        self._diff: Dict = {}
        self._reset_next_step = True
        #: draws the last reset made before it kept one (1: no rejection)
        self.last_reset_attempts = 0

    # -- dm_env API ---------------------------------------------------------

    @property
    def physics(self):
        return _PhysicsView(self)

    @property
    def task(self):
        return self._task

    @property
    def random_state(self) -> np.random.RandomState:
        """The RandomState the episodes are drawn from (the reference keeps
        it on the task, dm_control/suite/base.py:48)."""
        return self._random

    def control_timestep(self) -> float:
        return self._control_timestep

    def _draw(self, m: Model, rc: RandomContext, init_fn, diff):
        """A fresh Data with an episode start drawn by ``init_fn`` and, where
        the task draws them, its activations."""
        d = make_data(m, 1)
        qpos, qvel, diff = init_fn(m, d.qpos, torch.zeros_like(d.qvel), rc,
                                   diff)
        d = d.replace(qpos=qpos, qvel=qvel)
        act = self._task.init_act(m, rc)
        if act is not None:
            d = d.replace(act=act)
        return d, diff

    def _settle(self, m: Model, d: Data) -> Data:
        """``task.settle_steps`` physics steps, then time 0.  The
        reference's settle loop runs inside ``reset_context``, so under
        Euler its first step integrates the drawn state with the forward
        of the state ``reset()`` left (qpos0, at rest)."""
        rest = self._task.settle_steps
        if m.opt.integrator != int(IntegratorType.RK4):
            d0 = engine.forward(m, make_data(m, 1))
            d = engine.euler(m, d0.replace(
                qpos=d.qpos, qvel=d.qvel, act=d.act, ctrl=d.ctrl,
                qacc_warmstart=d0.qacc))
            rest -= 1
        for _ in range(rest):
            d = engine.step(m, d)
        return d.replace(time=torch.zeros_like(d.time))

    @staticmethod
    def _refresh(m: Model, d: Data) -> Data:
        """The position and velocity stages and their sensors (the
        reference's mj_step2 / mj_step1 split): what a step's observation
        reads."""
        d = engine.fwd_position(m, d)
        d = sens.sensor_pos(m, d)
        d = engine.fwd_velocity(m, d)
        return sens.sensor_vel(m, d)

    def _reset_observe(self, m: Model, d: Data) -> Data:
        """The whole pipeline after a reset, with actuation off (the
        reference's forward after a reset runs with actuation disabled):
        the actuator forces are zeroed before the acceleration stage."""
        d = self._refresh(m, d)
        d = d.replace(qfrc_actuator=torch.zeros_like(d.qfrc_actuator),
                      actuator_force=torch.zeros_like(d.actuator_force))
        d = engine.fwd_acceleration(m, d)
        d = engine.fwd_constraint(m, d)
        return sens.sensor_acc(m, d)

    def reset(self) -> environment.TimeStep:
        self._step_count = 0
        self._reset_next_step = False
        m, task = self._model, self._task
        rc = RandomContext.numpy(self._random, m.device, m.dtype)
        diff = task.initial_model_diff(m)
        init_fn = task.init
        for attempt in range(max(1, task.max_reset_rejections)):
            d, diff = self._draw(m, rc, init_fn, diff)
            init_fn = task.reject_reinit
            mm = apply_model_diff(m, diff)
            if task.settle_steps:
                d = self._settle(mm, d)
            if not (task.max_reset_rejections and bool(task.reject(mm, d)[0])):
                break
        self.last_reset_attempts = attempt + 1
        self._data = self._reset_observe(mm, d)
        self._diff = diff
        return environment.TimeStep(
            environment.StepType.FIRST, None, None,
            _to_numpy_obs(task.observation(mm, self._data)))

    def step(self, action) -> environment.TimeStep:
        if self._reset_next_step or self._data is None:
            return self.reset()
        m = apply_model_diff(self._model, self._diff)
        task = self._task
        action = torch.as_tensor(np.asarray(action), dtype=m.dtype,
                                 device=m.device).reshape(1, m.nu)
        d = task.before_step(m, self._data, action)
        for _ in range(self._n_sub_steps):
            d = engine.step(m, d)
        d = self._data = self._refresh(m, d)
        self._step_count += 1
        reward = float(task.reward(m, d)[0])
        obs = _to_numpy_obs(task.observation(m, d))
        terminate, discount = task.termination(m, d)
        if bool(terminate[0]):
            self._reset_next_step = True
            return environment.TimeStep(environment.StepType.LAST, reward,
                                        float(discount[0]), obs)
        if self._step_count >= self._step_limit:
            self._reset_next_step = True
            return environment.TimeStep(environment.StepType.LAST, reward,
                                        1.0, obs)
        return environment.TimeStep(environment.StepType.MID, reward, 1.0,
                                    obs)

    def action_spec(self):
        return action_spec(self._model)

    def observation_spec(self):
        """Each observation's shape and dtype.  Before the first reset an
        episode start is drawn from a RandomState of its own: the query
        takes nothing from the episodes' stream."""
        m = self._model
        if self._data is not None:
            d, diff = self._data, self._diff
        else:
            rc = RandomContext.numpy(np.random.RandomState(0), m.device,
                                     m.dtype)
            d, diff = self._draw(m, rc, self._task.init,
                                 self._task.initial_model_diff(m))
        mm = apply_model_diff(m, diff)
        obs = _to_numpy_obs(self._task.observation(
            mm, self._reset_observe(mm, d)))
        return collections.OrderedDict(
            (k, specs.Array(shape=v.shape, dtype=v.dtype, name=k))
            for k, v in obs.items())


class _PhysicsView:
    """Read access to an ``Environment``'s current state: ``model`` and
    ``data`` (one environment, no batch axis), read from the environment
    at each access (a camera or a viewer holding the view sees every
    step)."""

    def __init__(self, env: "Environment"):
        self._env = env
        self.model = env._model

    @property
    def _data(self) -> Optional[Data]:
        return self._env._data

    @property
    def data(self) -> Data:
        return env_view(self._data)

    def time(self) -> float:
        return float(self._data.time[0])

    def render(self, height=240, width=320, camera_id=-1, overlays=(),
               depth=False, segmentation=False, scene_option=None,
               render_flag_overrides=None, scene_callback=None):
        """Ray-cast render of the current state on the model's device
        (engine.py:168-217)."""
        from dm_control_torch import rendering

        return rendering.render(self, height=height, width=width,
                                camera_id=camera_id, depth=depth,
                                segmentation=segmentation)


def action_spec(model: Model) -> specs.BoundedArray:
    """The actuators' control ranges, unbounded where a control is not
    limited (dm_control/mujoco/engine.py:1018), named by the actuators'
    names joined with tabs."""
    minima = np.full(model.nu, -np.inf)
    maxima = np.full(model.nu, np.inf)
    limited = np.asarray(model.actuator_ctrllimited, bool)
    ctrlrange = model.actuator_ctrlrange.detach().cpu().numpy().astype(
        np.float64)
    minima[limited] = ctrlrange[limited, 0]
    maxima[limited] = ctrlrange[limited, 1]
    names = [""] * model.nu
    for name, i in model.names.actuator.items():
        names[i] = name or ""
    return specs.BoundedArray(shape=(model.nu,), dtype=np.float64,
                              minimum=minima, maximum=maxima,
                              name="\t".join(names))


def _to_numpy_obs(obs):
    """A task's (1, ...) observations as unbatched numpy arrays."""
    return collections.OrderedDict(
        (k, v[0].detach().cpu().numpy()) for k, v in obs.items())


def flatten_observation(observation, output_key="observations"):
    """Dict observations as one vector under ``output_key``
    (dm_control/rl/control.py:368)."""
    if not isinstance(observation, collections.abc.MutableMapping):
        raise ValueError("Can only flatten dict-like observations.")
    arrays = [np.asarray(v).ravel() for v in observation.values()]
    return type(observation)([(output_key, np.concatenate(arrays))])
