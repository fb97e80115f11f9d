"""Evaluation of a behaviour-cloning policy and open-loop replay of
reference actions (counterpart of ``dm_control_tpu/scripts/evaluate.py``;
reference: dm_control/scripts/evaluate.py: observation assembly (:23-38),
policy rollouts with context-window action prediction (``run_episode``,
:87-118), open-loop replay (``run_episode_with_reference_actions``,
:120-144; ``validate_reference_actions``, :73), the model from its config
and checkpoint (:149-175), return and action MSE (``evaluate``, :177-191)
and ``comprehensive_eval`` over saved action files (:193-222)).

The policy runs on the device its model lives on (``load_model``: the
card unless the caller asks for the CPU), under ``torch.no_grad``.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from dm_control_torch.scripts.model import FFConfig, FFNet, GPT, GPTConfig


def observables_sorted(observation):
    """The observables' keys, sorted (reference evaluate.py:23-26)."""
    return sorted(observation.keys())


def build_observation(time_step, observables=None):
    """The selected observables flattened and concatenated in sorted-key
    order, float32 (reference evaluate.py:28-38)."""
    obs = time_step.observation
    keys = observables or observables_sorted(obs)
    parts = [np.atleast_1d(np.asarray(obs[k], np.float32)).ravel()
             for k in keys]
    return np.concatenate(parts)


def load_model(config_path, model_path, *, device="cuda"):
    """The model of a saved config (a GPT's, else an FFNet's) with its
    checkpoint's state dict, on ``device`` (reference
    evaluate.py:149-175).  Returns (model, config)."""
    try:
        config = GPTConfig.from_json(config_path)
        model = GPT(config)
    except TypeError:
        config = FFConfig.from_json(config_path)
        model = FFNet(config)
    model.load_state_dict(torch.load(model_path, map_location=device,
                                     weights_only=True))
    return model.to(device).eval(), config


def policy_fn(model, config):
    """The policy of a history of observations: the last ``block_size``
    of them through the model, the action at the last position (an
    FFNet's of the last observation alone); numpy out (reference
    evaluate.py:87-118)."""
    param = next(model.parameters())

    @torch.no_grad()
    def act(obs):
        x = torch.as_tensor(obs).to(param.device, param.dtype)
        return model(x[None])[0][0].cpu().numpy()

    if isinstance(model, FFNet):
        return lambda history: act(np.asarray(history[-1]))
    return lambda history: act(
        np.stack(history[-config.block_size:]))[-1]


def run_episode(env, model, config, reference_actions=None, context_steps=0,
                observables=None):
    """Rolls the policy out; the first ``context_steps`` actions come open
    loop from ``reference_actions`` to build the context (reference
    evaluate.py:87-118).  Returns (return, predicted actions, mean squared
    error against the reference actions or None)."""
    policy = policy_fn(model, config)
    ts = env.reset()
    history = [build_observation(ts, observables)]
    total, preds, errs = 0.0, [], []
    t = 0
    while not ts.last():
        a = policy(history)
        if reference_actions is not None and t < len(reference_actions):
            ref = np.asarray(reference_actions[t])
            errs.append(float(np.mean((a - ref) ** 2)))
            if t < context_steps:
                a = ref
        ts = env.step(a)
        total += float(ts.reward or 0.0)
        preds.append(a)
        history.append(build_observation(ts, observables))
        t += 1
        if reference_actions is not None and t >= len(reference_actions):
            break
    mse = float(np.mean(errs)) if errs else None
    return total, np.asarray(preds), mse


def run_episode_with_reference_actions(env, reference_actions):
    """Open-loop replay (reference evaluate.py:120-144).  Returns (return,
    observations)."""
    ts = env.reset()
    total, obs = 0.0, [build_observation(ts)]
    for a in reference_actions:
        ts = env.step(a)
        total += float(ts.reward or 0.0)
        obs.append(build_observation(ts))
        if ts.last():
            break
    return total, np.asarray(obs)


def validate_reference_actions(env, reference_actions, expected_return,
                               tol=1e-3):
    """Whether an open-loop replay reproduces the recorded return within
    ``tol`` (reference evaluate.py:73-85).  Returns (ok, return)."""
    total, _ = run_episode_with_reference_actions(env, reference_actions)
    return abs(total - expected_return) <= tol, total


def evaluate(env, model, config, reference_actions=None, context_steps=0,
             observables=None):
    """{policy_return, reference_return, action_mse} (reference
    evaluate.py:177-191)."""
    out = {}
    if reference_actions is not None:
        ref_ret, _ = run_episode_with_reference_actions(
            env, reference_actions)
        out["reference_return"] = ref_ret
    ret, _, mse = run_episode(env, model, config, reference_actions,
                              context_steps, observables)
    out["policy_return"] = ret
    out["action_mse"] = mse
    return out


def comprehensive_eval(eval_dir, make_env, model, config, context_steps=32):
    """``evaluate`` over every ``opt_acts_*.npy`` of ``eval_dir``, each in
    the environment ``make_env(path)`` builds (reference
    evaluate.py:193-222)."""
    results = {}
    for path in sorted(glob.glob(os.path.join(eval_dir, "opt_acts_*.npy"))):
        ref = np.load(path)
        env = make_env(path)
        results[os.path.basename(path)] = evaluate(
            env, model, config, reference_actions=ref,
            context_steps=context_steps)
    return results
