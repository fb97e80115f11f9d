"""Builds an HDF5 behaviour-cloning dataset by replaying saved action files
(counterpart of ``dm_control_tpu/scripts/create_dataset.py``; reference:
dm_control/scripts/create_dataset.py: ``opt_acts_*.npy`` files gathered
from job directories (:23-48,109-123), their actions replayed to collect
the observables (``run_episode``, :84-107), the episodes concatenated
and written (``create_dataset``, :125-182)).

The replay runs on ``--device``, the card by default, in float32 (the JAX
script runs at JAX's default precision):

    python -m dm_control_torch.scripts.create_dataset \
        --input_dirs=<dir,...> --output_path=out.hdf5
    python -m dm_control_torch.scripts.create_dataset --device=cpu ...
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def run_episode(env, actions):
    """Replays ``actions`` from a reset; returns (observables: name ->
    (steps, dim) float32, rewards (steps,)), one row per action taken
    (reference create_dataset.py:84-107)."""
    ts = env.reset()
    obs_rows = {k: [np.atleast_1d(np.asarray(v, np.float32)).ravel()]
                for k, v in ts.observation.items()}
    rewards = []
    for a in actions:
        ts = env.step(a)
        for k, v in ts.observation.items():
            obs_rows[k].append(
                np.atleast_1d(np.asarray(v, np.float32)).ravel())
        rewards.append(float(ts.reward or 0.0))
        if ts.last():
            break
    n = len(rewards)
    obs = {k: np.stack(v[:n]) for k, v in obs_rows.items()}
    return obs, np.asarray(rewards)


def gather_action_files(input_dirs):
    """The ``opt_acts_*.npy`` files of each directory, sorted (reference
    create_dataset.py:109-123)."""
    files = []
    for d in input_dirs:
        files.extend(sorted(glob.glob(os.path.join(d, "opt_acts_*.npy"))))
    return files


def replay_files(make_env, action_files):
    """Replays every action file in the environment ``make_env(path)``
    builds; returns the dataset's rows (observables: name -> array,
    actions float32, dones, rewards), one episode a file, the last row of
    each done."""
    all_obs, all_acts, all_dones, all_rewards = {}, [], [], []
    for path in action_files:
        actions = np.load(path)
        env = make_env(path)
        obs, rewards = run_episode(env, actions)
        n = len(rewards)
        for k, v in obs.items():
            all_obs.setdefault(k, []).append(v)
        all_acts.append(np.asarray(actions[:n], np.float32))
        dones = np.zeros(n, bool)
        dones[-1] = True
        all_dones.append(dones)
        all_rewards.append(rewards)
        print(f"{os.path.basename(path)}: {n} steps, "
              f"return {rewards.sum():.3f}")
    return ({k: np.concatenate(v) for k, v in all_obs.items()},
            np.concatenate(all_acts), np.concatenate(all_dones),
            np.concatenate(all_rewards))


def create_dataset(make_env, action_files, output_path):
    """Replays every action file and writes the HDF5 dataset that
    ``TrajectoryDataset`` reads (reference create_dataset.py:125-182).
    Returns the rows written (``replay_files``)."""
    from dm_control_torch.scripts.dataset import write_h5

    rows = replay_files(make_env, action_files)
    write_h5(output_path, *rows)
    print(f"wrote {output_path}")
    return rows


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input_dirs", type=lambda s: s.split(","),
                        default=["."],
                        help="Directories with opt_acts_*.npy.")
    parser.add_argument("--output_path", default="trajectory_dataset.hdf5",
                        help="Output HDF5 path.")
    parser.add_argument("--domain", default="cartpole",
                        help="Suite domain to replay in.")
    parser.add_argument("--task", default="swingup",
                        help="Suite task to replay in.")
    parser.add_argument("--seed", type=int, default=0,
                        help="Env seed used when the actions were "
                             "optimized.")
    parser.add_argument("--device", default="cuda",
                        help="Where the physics runs.")
    return parser.parse_args(argv)


def main(argv=None):
    import torch

    from dm_control_torch import suite

    args = parse_args(argv)

    def make_env(path):
        return suite.load(args.domain, args.task,
                          task_kwargs={"random": args.seed},
                          device=args.device, dtype=torch.float32)

    files = gather_action_files(args.input_dirs)
    if not files:
        raise SystemExit("no opt_acts_*.npy found in input_dirs")
    return create_dataset(make_env, files, args.output_path)


if __name__ == "__main__":
    main()
