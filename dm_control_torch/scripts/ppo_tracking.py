"""PPO on mocap tracking (counterpart of
``dm_control_tpu/scripts/ppo_tracking.py``; reference:
dm_control/scripts/ppo_tracking.py).

Builds the multi-clip tracking task of the CMU humanoid on a ``Floor``
(``locomotion/tasks/reference_pose/tracking.py``), steps it through a
``DummyVecEnv`` of ``composer.Environment``s (their hooks run on the
host) and trains an ``ActorCritic`` with ``PPOTrainer``.  The physics and
the policy run on ``--device``, the card by default:

    python -m dm_control_torch.scripts.ppo_tracking --max_epochs=2
    python -m dm_control_torch.scripts.ppo_tracking --max_epochs=1 \
        --n_envs=2 --steps_per_epoch=64 --device=cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_env(clip_name="synthetic_walk", seed=42, time_limit=8.0, *,
              device="cuda", dtype: torch.dtype = torch.float32):
    """The tracking environment of clip ``clip_name``: from the CMU 2019
    h5 where ``loader.cmu_mocap_path`` finds it, else a synthetic walking
    clip of 240 frames; every episode starts at the clip's start, and
    ends where the tracking error passes 50.  The physics runs in float32,
    as the JAX package's script runs (JAX's default precision)."""
    from dm_control_torch import composer
    from dm_control_torch.locomotion.arenas import floors
    from dm_control_torch.locomotion.mocap import loader
    from dm_control_torch.locomotion.mocap.types import ClipCollection
    from dm_control_torch.locomotion.tasks.reference_pose import tracking
    from dm_control_torch.locomotion.walkers.cmu_humanoid import CMUHumanoid

    walker = CMUHumanoid()
    arena = floors.Floor()
    try:
        trajectories = loader.cmu_mocap_path()
    except FileNotFoundError:
        nq = 7 + len(walker.observable_joint_names)
        trajectories = {clip_name: loader.synthetic_walking_trajectory(
            nq=nq, nv=nq - 1, num_steps=240)}
    task = tracking.MultiClipMocapTracking(
        walker=walker, arena=arena,
        ref_path_or_trajectories=trajectories,
        dataset=ClipCollection(ids=(clip_name,)),
        ref_steps=(1, 2, 3, 4, 5),
        termination_error_threshold=50.0,
        always_init_at_clip_start=True)
    return composer.Environment(
        task=task, time_limit=time_limit,
        random_state=np.random.RandomState(seed), device=device,
        dtype=dtype)


class EnvWrap:
    """A dm_env environment committed to some observables: ``reset``
    gives their values flattened and concatenated in the order given."""

    def __init__(self, env, observables):
        self.env = env
        self.observables = list(observables)

    def reset(self):
        return self._obs(self.env.reset())

    def _obs(self, time_step):
        parts = []
        for o in self.observables:
            v = np.asarray(time_step.observation[o], np.float32)
            parts.append(v.ravel())
        return np.concatenate(parts)

    def step(self, action):
        return self.env.step(action)

    def action_spec(self):
        return self.env.action_spec()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_envs", type=int, default=4,
                        help="Parallel environments.")
    parser.add_argument("--max_epochs", type=int, default=100,
                        help="Training epochs.")
    parser.add_argument("--steps_per_epoch", type=int, default=2048,
                        help="Env steps per epoch.")
    parser.add_argument("--clip_name", default="synthetic_walk",
                        help="Mocap clip id.")
    parser.add_argument("--seed", type=int, default=42, help="Seed.")
    parser.add_argument("--observables",
                        type=lambda s: s.split(","),
                        default=["walker/joints_pos", "walker/joints_vel"],
                        help="Observables defining the task.")
    parser.add_argument("--device", default="cuda",
                        help="Where the physics and the policy run.")
    return parser.parse_args(argv)


def make_trainer(args):
    """The ``PPOTrainer`` of parsed arguments: a ``DummyVecEnv`` of
    ``n_envs`` tracking environments, an evaluation environment seeded
    ``seed + 1`` and an ``ActorCritic`` sized to them."""
    from dm_control_torch.scripts.model import ActorCritic
    from dm_control_torch.scripts.ppo import PPOTrainer, PPOTrainerConfig
    from dm_control_torch.scripts.vec_env import (
        DummyVecEnv, flatten_obs_dict,
    )

    def make():
        return build_env(args.clip_name, args.seed, device=args.device)

    venv = DummyVecEnv([make for _ in range(args.n_envs)])
    eval_env = build_env(args.clip_name, args.seed + 1, device=args.device)
    action_size = eval_env.action_spec().shape[0]
    obs_size = flatten_obs_dict(eval_env.reset().observation).shape[0]
    policy = ActorCritic(obs_size, action_size)
    config = PPOTrainerConfig(max_epochs=args.max_epochs,
                              steps_per_epoch=args.steps_per_epoch,
                              seed=args.seed)
    return PPOTrainer(policy, venv, eval_env, config, device=args.device)


def main(argv=None):
    trainer = make_trainer(parse_args(argv))
    history = trainer.train()
    print("eval return:", trainer.evaluate())
    return history


if __name__ == "__main__":
    main()
