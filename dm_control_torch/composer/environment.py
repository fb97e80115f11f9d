"""Composer environment: the hook-driven episode loop (counterpart of
``dm_control_tpu/composer/environment.py``).

Reference: dm_control/composer/environment.py:104-399 — hook pipeline
``initialize_episode_mjcf → (compile) → after_compile →
initialize_episode → [before_step → n×(before_substep, physics.step,
after_substep, updater.update) → after_step]``.

The MJCF model is compiled once at construction (the port's
``mjcf.compile_model``, onto ``device`` in ``dtype``), not per episode.
``initialize_episode_mjcf`` still runs each episode; with
``recompile_mjcf_every_episode`` the tree is compiled again after it.
Per-episode changes of a compiled model are made by replacing the
physics' ``Model`` (``Duplo.apply_stud_radius``).  The hooks and the
observables run on the host and read the physics through numpy copies.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_torch.composer.observation.updater import Updater
from dm_control_torch.mjcf.compiler import compile_model
from dm_control_torch.physics.physics import Physics, PhysicsError
from dm_control_torch.rl import environment
from dm_control_torch.rl.control import compute_n_steps
from dm_control_torch.suite import check_device


class EpisodeInitializationError(RuntimeError):
    """Raised when an episode fails to initialize
    (reference environment.py:55)."""


class Environment(environment.Environment):
    """Hook-driven environment over a composer Task, its physics on
    ``device`` (the card unless the caller asks for another,
    ``device="cpu"``; without CUDA the default raises) in ``dtype``."""

    def __init__(self, task, time_limit=float("inf"), random_state=None,
                 n_sub_steps=None,
                 raise_exception_on_physics_error=True,
                 strip_singleton_obs_buffer_dim=False,
                 max_reset_attempts=1,
                 recompile_mjcf_every_episode=False, *, device="cuda",
                 dtype: torch.dtype = torch.float64):
        check_device(f"composer.Environment({type(task).__name__})", device)
        self._task = task
        if not isinstance(random_state, np.random.RandomState):
            random_state = np.random.RandomState(random_state)
        self._random_state = random_state
        self._time_limit = time_limit
        self._raise_on_error = raise_exception_on_physics_error
        self._max_reset_attempts = max_reset_attempts
        self._recompile_every_episode = recompile_mjcf_every_episode
        self._strip = strip_singleton_obs_buffer_dim
        self._device = device
        self._dtype = dtype

        self._recompile_physics()
        if n_sub_steps is not None:
            self._n_sub_steps = n_sub_steps
        else:
            self._n_sub_steps = compute_n_steps(
                task.control_timestep, task.physics_timestep)
        self._updater = None
        self._reset_next_step = True
        self._step_count = 0

    # -- compilation --------------------------------------------------------

    def _recompile_physics(self):
        root = self._task.root_entity.mjcf_model
        set_timestep(root, self._task.physics_timestep)
        self._physics = Physics(compile_model(root, device=self._device,
                                              dtype=self._dtype))

    @property
    def physics(self) -> Physics:
        return self._physics

    @property
    def task(self):
        return self._task

    def control_timestep(self):
        return self._task.control_timestep

    @property
    def random_state(self):
        return self._random_state

    # -- episode loop -------------------------------------------------------

    def reset(self) -> environment.TimeStep:
        failures = 0
        while True:
            try:
                return self._reset_attempt()
            except EpisodeInitializationError:
                failures += 1
                if failures >= self._max_reset_attempts:
                    raise

    def _reset_attempt(self):
        self._task.initialize_episode_mjcf(self._random_state)
        for entity in self._task.root_entity.iter_entities():
            entity.initialize_episode_mjcf(self._random_state)
        if self._recompile_every_episode:
            self._recompile_physics()
        self._task.after_compile(self._physics, self._random_state)

        with self._physics.reset_context():
            self._task.initialize_episode(self._physics, self._random_state)
            for entity in self._task.root_entity.iter_entities():
                entity.initialize_episode(self._physics, self._random_state)

        self._updater = Updater(
            self._task.observables, self._n_sub_steps, self._strip)
        self._updater.reset(self._physics, self._random_state)
        self._reset_next_step = False
        self._step_count = 0
        return environment.TimeStep(
            environment.StepType.FIRST, None, None,
            self._updater.get_observation())

    def step(self, action) -> environment.TimeStep:
        if self._reset_next_step:
            return self.reset()
        task, physics, rs = self._task, self._physics, self._random_state
        try:
            task.before_step(physics, action, rs)
            for entity in task.root_entity.iter_entities():
                entity.before_step(physics, rs)
            self._updater.prepare_for_next_control_step()
            for _ in range(self._n_sub_steps):
                task.before_substep(physics, action, rs)
                for entity in task.root_entity.iter_entities():
                    entity.before_substep(physics, rs)
                physics.step()
                for entity in task.root_entity.iter_entities():
                    entity.after_substep(physics, rs)
                task.after_substep(physics, rs)
                self._updater.update(physics, rs)
            task.after_step(physics, rs)
            for entity in task.root_entity.iter_entities():
                entity.after_step(physics, rs)
        except PhysicsError:
            # divergence: absorb as termination unless configured to raise
            # (reference environment.py:358-391)
            if self._raise_on_error:
                raise
            self._reset_next_step = True
            return environment.TimeStep(environment.StepType.LAST, 0.0, 0.0,
                                        self._updater.get_observation())

        self._step_count += 1
        reward = task.get_reward(physics)
        # multi-agent tasks return per-player reward sequences
        reward = (np.asarray(reward, dtype=float)
                  if isinstance(reward, (list, tuple, np.ndarray))
                  else float(reward))
        obs = self._updater.get_observation()
        if task.should_terminate_episode(physics):
            self._reset_next_step = True
            return environment.TimeStep(environment.StepType.LAST, reward,
                                        float(task.get_discount(physics)),
                                        obs)
        if (self._step_count * self._task.control_timestep
                >= self._time_limit - 1e-9):
            self._reset_next_step = True
            return environment.TimeStep(environment.StepType.LAST, reward,
                                        1.0, obs)
        return environment.TimeStep(environment.StepType.MID, reward, 1.0,
                                    obs)

    # -- specs --------------------------------------------------------------

    def action_spec(self):
        return self._task.action_spec(self._physics)

    def observation_spec(self):
        if self._updater is None:
            self.reset()
        return self._updater.observation_spec()


def set_timestep(root, timestep):
    """Writes ``timestep`` into the tree's ``<option>`` (added where it has
    none), as the environment does before it compiles."""
    opt = root.first("option")
    if opt is None:
        opt = root.add("option")
    opt.attrib["timestep"] = str(timestep)
