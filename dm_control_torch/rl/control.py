"""Episode state, timestep payload and the task interface, batch-first.

Counterpart of the functional core of ``dm_control_tpu/rl/control.py``.
Randomness comes from an explicit ``torch.Generator`` on the batch's
device; ``RandomContext`` draws one value per environment for every
logical draw a task makes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from dm_control_torch.physics.model import Data, Model

# dm_env.StepType values
FIRST = 0
MID = 1
LAST = 2


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
    reward: torch.Tensor  # (B,)
    discount: torch.Tensor  # (B,)
    observation: Any  # OrderedDict[str, (B, ...)]


class RandomContext:
    """Batched random draws from one ``torch.Generator``: every call
    returns a tensor with the batch ``B`` first."""

    def __init__(self, generator: torch.Generator, batch: int,
                 dtype: torch.dtype):
        self.generator = generator
        self.batch = batch
        self.dtype = dtype

    def rand(self, *size):
        """U[0, 1) of shape (B, *size)."""
        return torch.rand((self.batch, *size), generator=self.generator,
                          dtype=self.dtype, device=self.generator.device)

    def randn(self, *size):
        """N(0, 1) of shape (B, *size)."""
        return torch.randn((self.batch, *size), generator=self.generator,
                           dtype=self.dtype, device=self.generator.device)

    def uniform(self, low, high, *size):
        """U[low, high) of shape (B, *size); ``low`` and ``high`` are
        numbers or tensors that broadcast against ``size``."""
        return low + (high - low) * self.rand(*size)

    def randint(self, low, high, *size):
        """Integers uniform in [low, high) of shape (B, *size), int64."""
        return torch.randint(low, high, (self.batch, *size),
                             generator=self.generator,
                             device=self.generator.device)


class Task:
    """Functional task interface over batched (Model, Data)."""

    #: physics steps after init to settle the state
    settle_steps: int = 0
    #: re-draw the initial state while ``reject(m, d)`` holds
    max_reset_rejections: int = 0
    #: deepest pipeline stage observation/reward/termination read:
    #: "vel" (position and velocity stage) or "acc"
    observation_stages: str = "acc"

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

