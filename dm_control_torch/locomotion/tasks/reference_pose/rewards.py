"""The mocap tracking rewards, batched (counterpart of
``dm_control_tpu/locomotion/tasks/reference_pose/rewards.py``).

Every feature is a tensor with the environments first, and every sum
over a feature runs over all its axes but that one: a reward is (B,).
Squared differences are sums over the feature; features named
``*quaternion*`` use the bounded quaternion distance.
"""

from __future__ import annotations

import collections

import torch

RewardFnOutput = collections.namedtuple(
    "RewardFnOutput", ["reward", "debug", "reward_terms"])


def sort_dict(d):
    return collections.OrderedDict(sorted(d.items()))


def _sum_per_env(x):
    """The sum of (B, ...) over every axis but the first."""
    return x.reshape(x.shape[0], -1).sum(-1)


def bounded_quat_dist(source, target):
    """The angle between two rotations, at most pi: arccos(|<s, t>|) of the
    normalised quaternions (the last axis)."""
    target = torch.as_tensor(target, dtype=source.dtype,
                             device=source.device)
    source = source / torch.linalg.vector_norm(source, dim=-1, keepdim=True)
    target = target / torch.linalg.vector_norm(target, dim=-1, keepdim=True)
    dot = (source * target).sum(-1).abs()
    return torch.arccos(dot.clamp(0.0, 1.0))


def compute_squared_differences(walker_features, reference_features,
                                exclude_keys=()):
    """Per feature, the summed squared difference of each environment:
    ``sum((w - r)**2)``, the summed squared bounded distances for
    ``*quaternions`` and the squared one for ``*quaternion``."""
    out = {}
    for k in walker_features:
        if k in exclude_keys or k not in reference_features:
            continue
        w = walker_features[k]
        r = reference_features[k]
        if "quaternion" not in k:
            out[k] = _sum_per_env((w - r) ** 2)
        else:
            out[k] = _sum_per_env(bounded_quat_dist(w, r) ** 2)
    return out


def termination_reward_fn(termination_error, termination_error_threshold,
                          **unused_kwargs):
    """1 - error / threshold."""
    debug = {"termination_error": termination_error,
             "termination_error_threshold": termination_error_threshold}
    reward = 1 - termination_error / termination_error_threshold
    return RewardFnOutput(reward=reward, debug=debug,
                          reward_terms=sort_dict({"termination": reward}))


def debug(reference_features, walker_features, **unused_kwargs):
    terms = compute_squared_differences(walker_features, reference_features)
    return RewardFnOutput(reward=0.0, debug=terms, reward_terms=None)


def multi_term_pose_reward_fn(walker_features, reference_features,
                              **unused_kwargs):
    """A mixture of the centre of mass, joint velocities, appendages and
    body quaternions."""
    d = compute_squared_differences(walker_features, reference_features)
    terms = {
        "center_of_mass": 0.1 * torch.exp(-10 * d["center_of_mass"]),
        "joints_velocity": 1.0 * torch.exp(-0.1 * d["joints_velocity"]),
        "appendages": 0.15 * torch.exp(-40.0 * d["appendages"]),
        "body_quaternions": 0.65 * torch.exp(-2 * d["body_quaternions"]),
    }
    return RewardFnOutput(reward=sum(terms.values()), debug=terms,
                          reward_terms=sort_dict(terms))


def comic_reward_fn(termination_error, termination_error_threshold,
                    walker_features, reference_features, **unused_kwargs):
    """Half the termination reward and half the multi-term pose reward
    (CoMic, Hasenclever et al. 2020)."""
    term = termination_reward_fn(termination_error,
                                 termination_error_threshold)
    mt = multi_term_pose_reward_fn(walker_features, reference_features)
    debug_terms = dict(term.debug)
    debug_terms.update(mt.debug)
    reward_terms = {k: 0.5 * v for k, v in term.reward_terms.items()}
    reward_terms.update({k: 0.5 * v for k, v in mt.reward_terms.items()})
    return RewardFnOutput(
        reward=0.5 * term.reward + 0.5 * mt.reward,
        debug=debug_terms, reward_terms=sort_dict(reward_terms))


def com_reward_fn(termination_error, termination_error_threshold,
                  walker_features, reference_features, **unused_kwargs):
    """The centre of mass's cost alone."""
    d = compute_squared_differences(walker_features, reference_features)
    return RewardFnOutput(reward=d["center_of_mass"], debug=d,
                          reward_terms=None)


def quat_reward_fn(termination_error, termination_error_threshold,
                   walker_features, reference_features, **unused_kwargs):
    """The body quaternions' cost alone."""
    d = compute_squared_differences(walker_features, reference_features)
    return RewardFnOutput(reward=d["body_quaternions"], debug=d,
                          reward_terms=None)


def kumquat_reward_fn(termination_error, termination_error_threshold,
                      walker_features, reference_features, **unused_kwargs):
    """3 times the centre of mass's cost plus the body quaternions'."""
    d = compute_squared_differences(walker_features, reference_features)
    return RewardFnOutput(
        reward=3 * d["center_of_mass"] + d["body_quaternions"],
        debug=d, reward_terms=None)


def supreme_reward_fn(termination_error, termination_error_threshold,
                      walker_features, reference_features, **unused_kwargs):
    """A weighted cost of the termination error and four features."""
    d = compute_squared_differences(walker_features, reference_features)
    cost = (18 * termination_error
            + 416.0 * d["center_of_mass"]
            + 7.4 * d["appendages"]
            + 0.0045 * d["joints_velocity"]
            + 1.25 * d["body_quaternions"])
    return RewardFnOutput(reward=cost, debug=d, reward_terms=None)


def termination_cost_fn(termination_error, termination_error_threshold,
                        **unused_kwargs):
    """The termination error as a cost."""
    debug = {"termination_error": termination_error,
             "termination_error_threshold": termination_error_threshold}
    return RewardFnOutput(reward=termination_error, debug=debug,
                          reward_terms=sort_dict(
                              {"termination": termination_error}))


_REWARD_FNS = {
    "termination_reward": termination_reward_fn,
    "multi_term_pose_reward": multi_term_pose_reward_fn,
    "multi_term_pose": multi_term_pose_reward_fn,
    "comic": comic_reward_fn,
    "com": com_reward_fn,
    "quat": quat_reward_fn,
    "kumquat": kumquat_reward_fn,
    "supreme": supreme_reward_fn,
    "termination": termination_cost_fn,
    "debug": debug,
}


def get_reward(key: str):
    return _REWARD_FNS[key]
