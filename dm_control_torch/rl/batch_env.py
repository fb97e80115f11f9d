"""Batched environment runtime: B environments stepped in lockstep.

Counterpart of ``dm_control_tpu/rl/batch_env.py``.  The batch is one
``EnvState`` whose tensors have the environments first; autoreset and
divergence are per-environment masks.  JAX's control flow becomes host
loops: the substep ``fori_loop`` a Python loop, the reset rejection
``while_loop`` a loop over a mask that ends when no environment is
rejected, and the autoreset ``cond`` a branch on ``needs_reset.any()``.

Where the JAX package takes its fused fast path, so does this one: a
model that ``physics/fastpath.py::build_step`` accepts (pendulum,
cartpole, acrobot, reacher, walker and cheetah among the suite's), under a
task whose per-episode model diff touches only ``DIFF_SAFE_FIELDS``
(reacher's target position), runs a control step's substeps and a reset's
settle steps as one call of the fused step: one kernel launch on the card,
the plain version on the CPU.  After it the Data holds the new state and
the template's values in every derived field, as in the JAX package; the
observation then recomputes what it reads (through ``FastStep.fk_fields``
for a model without sensors).  Every other model runs ``engine.step``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

import torch

from dm_control_torch.physics import actuation as act_mod
from dm_control_torch.physics import collision
from dm_control_torch.physics import engine
from dm_control_torch.physics import fastpath
from dm_control_torch.physics import kinematics as kin
from dm_control_torch.physics import sensors as sens
from dm_control_torch.physics.model import Data, Model, make_data
from dm_control_torch.rl.control import (
    FIRST, LAST, MID, EnvState, RandomContext, Task, TimeStepData,
    apply_model_diff, compute_n_steps,
)

_STATE_FIELDS = ("qpos", "qvel", "act", "qacc_warmstart", "time")
_INT32_MAX = 2 ** 31 - 1


class BatchEnv:
    """Batched environment over one model and task.

        env = BatchEnv(model, task, time_limit=..., control_timestep=...)
        state, ts = env.reset(batch, generator)
        state, ts = env.step(state, actions)     # actions (B, nu)

    ``step`` resets the environments whose previous step was LAST (or
    diverged), drawing their new episodes from ``state.rng``.

    ``contact_cap`` sets contact compaction (``constraints.
    _contact_rows_compact``), as in the JAX package: None engages it at
    64 contacts per condim group for a float32 model with more than 512
    candidate contacts; 0 turns it off; an integer pins the cap.
    """

    def __init__(self, model: Model, task: Task,
                 time_limit: float = float("inf"),
                 control_timestep: Optional[float] = None,
                 autoreset: bool = True,
                 contact_cap: Optional[int] = None):
        if contact_cap is None:
            ncand = len(collision.contact_rows_static(model)[0])
            contact_cap = 64 if (model.dtype == torch.float32
                                 and ncand > 512) else 0
        if contact_cap:
            model = model.replace(opt=model.opt.replace(
                contact_cap=int(contact_cap)))
        self.model = model
        self.task = task
        self.autoreset = autoreset
        physics_timestep = float(model.opt.timestep)
        control_timestep = control_timestep or physics_timestep
        self.n_sub_steps = compute_n_steps(control_timestep,
                                           physics_timestep, tolerance=1e-4)
        if time_limit == float("inf"):
            self.step_limit = _INT32_MAX
        else:
            self.step_limit = int(round(time_limit / control_timestep))
        # Between steps only the true physics state is carried; every
        # derived field is recomputed by the next forward().  Empty state
        # fields (act when na == 0) are not carried either.
        one = make_data(model, 1)
        self._state_fields = tuple(f for f in _STATE_FIELDS
                                   if getattr(one, f)[0].numel() > 0)
        self._templates: Dict[int, Data] = {}
        # the fused fast path, where the JAX package takes its own: the
        # model qualifies and the task's diff moves only geoms and sites
        self._fast = None
        if set(task.initial_model_diff(model)) <= fastpath.DIFF_SAFE_FIELDS:
            self._fast = fastpath.build_step(model)
        #: rounds the last reset's rejection loop took (for profiles)
        self.last_rejection_rounds = 0

    # -- stripped-carry helpers ---------------------------------------------

    def _template(self, batch: int) -> Data:
        if batch not in self._templates:
            self._templates[batch] = make_data(self.model, batch)
        return self._templates[batch]

    def _strip(self, d: Data) -> Data:
        return Data(**{f.name: getattr(d, f.name)
                       if f.name in self._state_fields else None
                       for f in dataclasses.fields(Data)})

    def _unstrip(self, d: Data) -> Data:
        return self._template(d.qpos.shape[0]).replace(
            **{f: getattr(d, f) for f in self._state_fields})

    def from_state(self, qpos, qvel, qacc_warmstart, time,
                   generator: torch.Generator,
                   model_diff: Optional[Dict] = None,
                   act=None) -> EnvState:
        """An EnvState at a given physics state (e.g. one taken from
        another implementation), with step_count 0 and, unless given, the
        task's initial model diff and zero activations."""
        B = qpos.shape[0]
        d = self._template(B).replace(qpos=qpos, qvel=qvel,
                                      qacc_warmstart=qacc_warmstart,
                                      time=time)
        if act is not None:
            d = d.replace(act=act)
        dev = qpos.device
        if model_diff is None:
            model_diff = self.task.initial_model_diff(self.model)
        return EnvState(data=self._strip(d), model_diff=model_diff,
                        rng=generator,
                        step_count=torch.zeros(B, dtype=torch.int32,
                                               device=dev),
                        needs_reset=torch.zeros(B, dtype=torch.bool,
                                                device=dev))

    # -- episode start ------------------------------------------------------

    def _init_state(self, batch: int, generator: torch.Generator
                    ) -> EnvState:
        m, task = self.model, self.task
        d = make_data(m, batch)
        diff = task.initial_model_diff(m)
        rc = RandomContext(generator, batch, d.qpos.dtype)
        qpos, qvel, diff = task.init(m, d.qpos, torch.zeros_like(d.qvel), rc,
                                     diff)
        d = d.replace(qpos=qpos, qvel=qvel)
        act = task.init_act(m, rc)
        if act is not None:
            d = d.replace(act=act)
        mm = apply_model_diff(m, diff)
        self.last_rejection_rounds = 0
        if task.max_reset_rejections:
            tries = torch.zeros(batch, dtype=torch.int32, device=m.device)
            while True:
                redo = task.reject(mm, d) & (tries < task.max_reset_rejections)
                if not bool(redo.any()):
                    break
                self.last_rejection_rounds += 1
                qp, qv, _ = task.init(m, m.qpos0.expand(batch, m.nq).clone(),
                                      torch.zeros_like(d.qvel), rc, diff)
                r1 = redo.unsqueeze(-1)
                d = d.replace(qpos=torch.where(r1, qp, d.qpos),
                              qvel=torch.where(r1, qv, d.qvel))
                act = task.init_act(m, rc)
                if act is not None:
                    d = d.replace(act=torch.where(r1, act, d.act))
                tries = tries + redo.to(torch.int32)
        if task.settle_steps:
            if self._fast is not None:
                qpos, qvel, warm = self._fast(d.qpos, d.qvel,
                                              d.qacc_warmstart, d.ctrl,
                                              task.settle_steps)
                d = d.replace(qpos=qpos, qvel=qvel, qacc_warmstart=warm)
            else:
                for _ in range(task.settle_steps):
                    d = engine.step(mm, d)
            d = d.replace(time=torch.zeros_like(d.time))
        return EnvState(data=d, model_diff=diff, rng=generator,
                        step_count=torch.zeros(batch, dtype=torch.int32,
                                               device=m.device),
                        needs_reset=torch.zeros(batch, dtype=torch.bool,
                                                device=m.device))

    def _observe(self, state: EnvState):
        m = apply_model_diff(self.model, state.model_diff)
        if self._fast is not None and self._fast.fk_observe_ok:
            # no sensors: the FK fields are all an observation reads
            d = state.data.replace(**self._fast.fk_fields(
                state.data.qpos, state.model_diff))
            return state.replace(data=d), self.task.observation(m, d)
        if self.task.observation_stages == "vel":
            # position/velocity-stage observables only: skip CRB,
            # collision, RNE and the acceleration-stage sensors
            d = kin.kinematics(m, state.data)
            d = kin.com_pos(m, d)
            d = kin.tendon(m, d)
            d = act_mod.transmission(m, d)
            d = sens.sensor_pos(m, d)
            d = act_mod.actuator_velocity(m, d)
            d = kin.tendon_velocity(m, d)
            d = kin.com_vel(m, d)
            d = sens.sensor_vel(m, d)
        else:
            # "acc": the acceleration-stage sensors too, at the new
            # position and velocity with the last substep's qacc and
            # contact forces (no constraint solve here)
            d = engine.fwd_position(m, state.data)
            d = sens.sensor_pos(m, d)
            d = engine.fwd_velocity(m, d)
            d = sens.sensor_vel(m, d)
            d = sens.sensor_acc(m, d)
        return state.replace(data=d), self.task.observation(m, d)

    def reset(self, batch: int, generator: torch.Generator):
        """New episodes for ``batch`` environments, drawn from
        ``generator`` (which also serves later autoresets)."""
        state, obs = self._observe(self._init_state(batch, generator))
        d = state.data
        ts = TimeStepData(
            step_type=torch.full((batch,), FIRST, dtype=torch.int32,
                                 device=d.qpos.device),
            reward=torch.zeros((batch,) + tuple(self.task.reward_shape),
                               dtype=d.qpos.dtype, device=d.qpos.device),
            discount=torch.ones(batch, dtype=d.qpos.dtype,
                                device=d.qpos.device),
            observation=obs)
        return state.replace(data=self._strip(d)), ts

    # -- stepping -----------------------------------------------------------

    def _plain_step(self, state: EnvState, action):
        m = apply_model_diff(self.model, state.model_diff)
        task = self.task
        d = task.before_step(m, self._unstrip(state.data), action)
        if self._fast is not None:
            qpos, qvel, warm = self._fast(d.qpos, d.qvel, d.qacc_warmstart,
                                          d.ctrl, self.n_sub_steps)
            # the time advances by n h at once, as in the JAX package
            d = d.replace(qpos=qpos, qvel=qvel, qacc_warmstart=warm,
                          time=d.time + self.n_sub_steps * m.opt.timestep)
        else:
            for _ in range(self.n_sub_steps):
                d = engine.step(m, d)
        state = state.replace(data=d, step_count=state.step_count + 1)
        state, obs = self._observe(state)
        d = state.data
        reward = task.reward(m, d)
        terminate, term_discount = task.termination(m, d)
        # divergence is a termination with discount 0
        diverged = engine.check_divergence(m, d)
        last = terminate | diverged | (state.step_count >= self.step_limit)
        # one discount per environment, whatever the reward's shape
        zero = torch.zeros_like(d.time)
        discount = torch.where(diverged, zero, torch.where(
            terminate, term_discount.to(zero.dtype), torch.ones_like(zero)))
        gone = diverged.reshape(diverged.shape + (1,) * (reward.ndim - 1))
        ts = TimeStepData(
            step_type=torch.where(last, LAST, MID).to(torch.int32),
            reward=torch.where(gone, torch.zeros_like(reward), reward),
            discount=discount, observation=obs)
        return state.replace(data=self._strip(d), needs_reset=last), ts

    def step(self, state: EnvState, action):
        """One control step of every environment, with amortized
        autoreset: the batch resets only on steps where some environment
        finished, and a mask merges the new episodes in."""
        stepped_state, stepped_ts = self._plain_step(state, action)
        if not self.autoreset or not bool(state.needs_reset.any()):
            return stepped_state, stepped_ts
        B = state.needs_reset.shape[0]
        new_state, new_ts = self.reset(B, state.rng)
        need = state.needs_reset

        def sel(a, b):
            if a is None:
                return None
            mask = need.reshape(need.shape + (1,) * (a.ndim - 1))
            return torch.where(mask, a, b)

        data = Data(**{f.name: sel(getattr(new_state.data, f.name),
                                   getattr(stepped_state.data, f.name))
                       for f in dataclasses.fields(Data)
                       if f.name != "contact"}, contact=None)
        state = stepped_state.replace(
            data=data,
            model_diff={k: sel(new_state.model_diff[k], v)
                        for k, v in stepped_state.model_diff.items()},
            step_count=sel(new_state.step_count, stepped_state.step_count),
            needs_reset=sel(new_state.needs_reset,
                            stepped_state.needs_reset))
        ts = TimeStepData(
            step_type=sel(new_ts.step_type, stepped_ts.step_type),
            reward=sel(new_ts.reward, stepped_ts.reward),
            discount=sel(new_ts.discount, stepped_ts.discount),
            observation=collections.OrderedDict(
                (k, sel(new_ts.observation[k], v))
                for k, v in stepped_ts.observation.items()))
        return state, ts


def rollout(env: BatchEnv, policy_fn, generator: torch.Generator,
            batch_size: int, n_steps: int):
    """Rolls ``batch_size`` new episodes out for ``n_steps`` with ``action =
    policy_fn(generator, obs)``; returns (final_state, per-env summed
    reward).  The reset, the autoresets and the policy all draw from
    ``generator``.  Utility for tests and benchmarks."""
    state, ts = env.reset(batch_size, generator)
    total = torch.zeros(batch_size, dtype=env.model.dtype,
                        device=env.model.device)
    for _ in range(n_steps):
        state, ts = env.step(state, policy_fn(generator, ts.observation))
        total = total + ts.reward
    return state, total
