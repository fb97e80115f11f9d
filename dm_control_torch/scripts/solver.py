"""Trajectory optimisation by sampling: the cross-entropy method on the
card (counterpart of ``dm_control_tpu/scripts/solver.py``; reference:
dm_control/scripts/solver.py, segment-wise derivative-free optimisation of
an action sequence against the return, with receding-horizon passes that
hand the physics state from one segment to the next, :60-71,146-268).

A population of candidate action segments rolls out together: the
environment's state (B = 1) is broadcast to B = population and stepped
as one batch through ``engine.step``, so every substep of every candidate
is one batched pass of the engine (``chol_solve`` at (population, nv)).
The elites refit a Gaussian and the method iterates.

    solver = CEMSolver.for_environment(env)
    actions = solver.solve(env.physics.data, total_steps=60, seed=0)
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_torch.physics import engine
from dm_control_torch.physics.model import Data, map_tensors
from dm_control_torch.rl.control import apply_model_diff


def normal(generator: torch.Generator, shape, dtype: torch.dtype
           ) -> torch.Tensor:
    """The candidates' standard normal noise, drawn from ``generator`` on
    its device (the one draw of the method)."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device)


def _batched(d: Data) -> Data:
    """``d`` with a batch axis: a Data of one environment without one (an
    environment's ``physics.data``) gains it."""
    if d.qpos.dim() == 1:
        return map_tensors(d, lambda v: v[None])
    return d


class CEMSolver:
    """Cross-entropy trajectory optimiser over a batched ``rl.control.Task``
    and the ``Model`` the environment steps (its per-episode diffs
    applied: ``for_environment``)."""

    def __init__(self, model, task, n_sub_steps=1, segment_length=20,
                 n_iterations=8, population=128, elite_frac=0.1,
                 init_std=0.3, min_std=0.02, ctrl_range=None):
        self.model = model
        self.task = task
        self.n_sub_steps = n_sub_steps
        self.segment_length = segment_length
        self.n_iterations = n_iterations
        self.population = population
        self.n_elite = max(1, int(round(elite_frac * population)))
        self.init_std = init_std
        self.min_std = min_std
        nu = model.nu
        like = dict(dtype=model.dtype, device=model.device)
        if ctrl_range is None:
            limited = torch.as_tensor(model.actuator_ctrllimited,
                                      device=model.device).bool()
            rng = torch.as_tensor(model.actuator_ctrlrange, **like)
            self._lo = torch.where(limited, rng[:, 0],
                                   torch.full((nu,), -1.0, **like))
            self._hi = torch.where(limited, rng[:, 1],
                                   torch.full((nu,), 1.0, **like))
        else:
            self._lo = torch.full((nu,), float(ctrl_range[0]), **like)
            self._hi = torch.full((nu,), float(ctrl_range[1]), **like)

    @classmethod
    def for_environment(cls, env, **kwargs):
        """The solver of a single ``rl.control.Environment`` after its
        reset: the model with the episode's diffs applied, the task and
        the substeps a control step the environment steps with."""
        kwargs.setdefault("n_sub_steps", env._n_sub_steps)
        return cls(apply_model_diff(env._model, env._diff), env.task,
                   **kwargs)

    def rollout(self, d0: Data, actions: torch.Tensor):
        """Each of the candidates ``actions`` (P, L, nu) from the one state
        ``d0``: the state broadcast to B = P, then per control step the
        task's ``before_step``, ``n_sub_steps`` engine steps and the
        task's reward.  Returns the summed rewards (P,) and the final
        state (B = P)."""
        m, task = self.model, self.task
        d0 = _batched(d0)
        P = actions.shape[0]
        d = map_tensors(d0, lambda v: v.expand(P, *v.shape[1:]).clone())
        total = torch.zeros(P, dtype=m.dtype, device=m.device)
        for t in range(actions.shape[1]):
            d = task.before_step(m, d, actions[:, t])
            for _ in range(self.n_sub_steps):
                d = engine.step(m, d)
            total = total + task.reward(m, d)
        return total, d

    def batch_returns(self, d0: Data, candidates: torch.Tensor):
        """The return of each candidate segment (P, L, nu) from ``d0``."""
        return self.rollout(d0, candidates)[0]

    def apply_segment(self, d0: Data, actions: torch.Tensor) -> Data:
        """The state (B = 1) after ``actions`` (L, nu) from ``d0``: the
        hand-off to the next segment."""
        return self.rollout(d0, actions[None])[1]

    def solve_segment(self, data: Data, generator: torch.Generator,
                      mean_init=None):
        """Optimises one segment from ``data`` (the reference's
        per-segment minimize, solver.py:146-189).  Returns (actions (L,
        nu), return)."""
        m = self.model
        L, nu = self.segment_length, m.nu
        like = dict(dtype=m.dtype, device=m.device)
        mean = (torch.zeros((L, nu), **like) if mean_init is None
                else torch.as_tensor(mean_init, **like))
        std = torch.full((L, nu), float(self.init_std), **like)
        best_acts, best_ret = mean, -float("inf")
        for _ in range(self.n_iterations):
            noise = normal(generator, (self.population, L, nu), m.dtype)
            cands = torch.clamp(mean + std * noise, self._lo, self._hi)
            rets = self.batch_returns(data, cands)
            # ascending -rets, stable, NaN last: the JAX argsort's order
            # (a largest-first topk would rank a NaN return first)
            elite_idx = torch.argsort(-rets, stable=True)[:self.n_elite]
            elites = cands[elite_idx]
            mean = elites.mean(dim=0)
            std = torch.clamp(elites.std(dim=0, correction=0),
                              min=self.min_std)
            top = float(rets[elite_idx[0]])
            if top > best_ret:
                best_ret = top
                best_acts = cands[elite_idx[0]]
        return best_acts, best_ret

    def solve(self, data: Data, total_steps, seed=0, mean_init=None,
              verbose=False):
        """Receding-horizon optimisation of ``total_steps`` actions from
        ``data`` (the reference's segment loop with its state hand-off,
        solver.py:217-268); the noise from a ``torch.Generator`` on the
        model's device seeded ``seed``.  Returns (total_steps, nu) numpy
        actions."""
        generator = torch.Generator(device=self.model.device)
        generator.manual_seed(seed)
        data = _batched(data)
        segments = []
        t = 0
        while t < total_steps:
            L = min(self.segment_length, total_steps - t)
            seg_mean = None
            if mean_init is not None:
                seg_mean = torch.as_tensor(
                    np.asarray(mean_init)[t:t + self.segment_length])
            acts, ret = self.solve_segment(data, generator, seg_mean)
            acts = acts[:L]
            data = self.apply_segment(data, acts)  # state hand-off
            segments.append(acts.detach().cpu().numpy())
            if verbose:
                print(f"segment @{t}: return {ret:.4f}")
            t += L
        return np.concatenate(segments, axis=0)


def save_actions(fname, actions):
    """Writes an ``opt_acts_*.npy`` file (the reference solver's output)."""
    np.save(fname, np.asarray(actions))
