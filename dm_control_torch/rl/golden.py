"""Holds a ``BatchEnv`` against a recorded control step of another
implementation of the same task.

A recording is a dict of arrays (the golden files that
``tools/export_torch_assets.py`` writes from the JAX package).  For each
start state ``<prefix>`` in ``PREFIXES`` it has the physics state
(``<prefix>_<field>`` for ``STATE_FIELDS``, and ``<prefix>_act`` where
the model has activations), the per-episode model
overrides (``<prefix>_diff_<field>``), the actions (``<prefix>_actions``)
and what one ``BatchEnv.step`` gave: ``<prefix>_step_<field>``,
``<prefix>_obs_<name>``, ``<prefix>_reward``, ``<prefix>_discount`` and
``<prefix>_step_type``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

STATE_FIELDS = ("qpos", "qvel", "qacc_warmstart", "time")
#: the gate of a recorded step: every key within ``ABS_GATE`` of the
#: recording, apart from ``qacc_warmstart`` (the solver's acceleration,
#: 1e3-1e5 on the contact-rich models, where 1e-9 absolute would ask for
#: 1e-14 relative), which is held to ``REL_GATE`` of its largest recorded
#: entry
ABS_GATE = 1e-9
REL_GATE = 1e-12
#: recorded beside them where the model has activations (na > 0)
ACT_FIELD = "act"
#: the recorded start states: after a reset, and some control steps later
PREFIXES = ("reset", "contact")


def model_diff(gold, prefix: str, rows=slice(None)) -> Dict[str, np.ndarray]:
    """The recording's per-episode model overrides at ``prefix``."""
    tag = f"{prefix}_diff_"
    return {k[len(tag):]: gold[k][rows] for k in gold if k.startswith(tag)}


def state_fields(gold, prefix: str = "reset"):
    """The state fields the recording holds at ``prefix``."""
    has_act = f"{prefix}_{ACT_FIELD}" in gold
    return STATE_FIELDS + ((ACT_FIELD,) if has_act else ())


def start_state(env, gold, prefix: str = "reset", rows=slice(None),
                seed: int = 0):
    """The EnvState of ``env`` at the recording's ``prefix`` start states,
    with its model overrides, on the device of the env's model."""
    dev = env.model.device
    diff = {k: torch.as_tensor(v, device=dev)
            for k, v in model_diff(gold, prefix, rows).items()}
    act = gold.get(f"{prefix}_{ACT_FIELD}")
    return env.from_state(
        *(torch.as_tensor(gold[f"{prefix}_{f}"][rows], device=dev)
          for f in STATE_FIELDS),
        generator=torch.Generator(device=dev).manual_seed(seed),
        model_diff=diff or None,
        act=None if act is None else torch.as_tensor(act[rows], device=dev))


def step_errors(env, gold, prefix: str) -> Dict[str, float]:
    """max |env - recording| of one ``env.step`` from the ``prefix`` start
    states, by recorded key (without the prefix): every state field, every
    observation, reward, discount and step type.  Raises ``ValueError``
    where the observation names or their order differ."""
    state, ts = env.step(start_state(env, gold, prefix), torch.as_tensor(
        gold[f"{prefix}_actions"], device=env.model.device))
    tag = f"{prefix}_obs_"
    names = [k[len(tag):] for k in gold if k.startswith(tag)]
    if list(ts.observation) != names:
        raise ValueError(f"observation {list(ts.observation)}, recorded "
                         f"{names}")
    got = {f"step_{f}": getattr(state.data, f)
           for f in state_fields(gold, prefix)}
    got.update({f"obs_{k}": v for k, v in ts.observation.items()})
    got.update(reward=ts.reward, discount=ts.discount,
               step_type=ts.step_type)
    return {k: float(np.abs(v.cpu().numpy() - gold[f"{prefix}_{k}"]).max())
            for k, v in got.items()}


def gate_figures(errs: Dict[str, float], gold, prefix: str):
    """(the largest deviation of every key but ``qacc_warmstart``, and
    ``qacc_warmstart``'s deviation over its largest recorded entry) of
    ``step_errors``' result; the step passes where the first is within
    ``ABS_GATE`` and the second within ``REL_GATE``."""
    qacc = "step_qacc_warmstart"
    scale = float(np.abs(gold[f"{prefix}_{qacc}"]).max())
    rest = max(v for k, v in errs.items() if k != qacc)
    return rest, errs[qacc] / max(scale, np.finfo(np.float64).tiny)
