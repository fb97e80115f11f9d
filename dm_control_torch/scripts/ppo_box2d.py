"""A PPO smoke run on an external (gym) environment (counterpart of
``dm_control_tpu/scripts/ppo_box2d.py``; reference:
dm_control/scripts/ppo_box2d.py, a sanity harness for the PPO learner on
BipedalWalker-v3 through ``SubprocVecEnv``).

Where gym imports, random BipedalWalker-v3 rollouts run through the
port's ``SubprocVecEnv``.  Where it does not (the card's machine has no
gym), the same learner loop runs on the suite's cartpole:swingup: the
port's ``rl/ppo.py`` (``make_train_step``, ``init_train_state``) on
``--device``, the card by default, in float32:

    python -m dm_control_torch.scripts.ppo_box2d [--updates N]
    python -m dm_control_torch.scripts.ppo_box2d --updates=2 --batch=8 \
        --device=cpu
"""

from __future__ import annotations

import argparse


def _gym_available() -> bool:
    try:
        import gym  # noqa: F401

        return True
    except ImportError:
        return False


def _make_bipedal_walker():
    # a module-level factory: SubprocVecEnv's spawned workers unpickle it
    import gym

    return gym.make("BipedalWalker-v3")


def run_gym_smoke(updates: int, batch: int):
    """The reference's path: BipedalWalker-v3 rollouts through the port's
    ``SubprocVecEnv``.  Only reachable where gym is installed."""
    import numpy as np

    from dm_control_torch.scripts.vec_env import SubprocVecEnv

    venv = SubprocVecEnv([_make_bipedal_walker for _ in range(4)])
    try:
        venv.reset()
        total = 0.0
        for _ in range(updates * 16):
            acts = (np.stack([venv.action_space.sample() for _ in range(4)])
                    if hasattr(venv, "action_space") else np.zeros((4, 4)))
            _, rew, _, _ = venv.step(acts)
            total += float(np.sum(rew))
    finally:
        venv.close()
    print(f"gym smoke: total reward {total:.2f}")
    return total


def run_suite_smoke(updates: int, batch: int, device="cuda"):
    """Without gym: the learner loop on cartpole:swingup at B = ``batch``.
    Returns the mean reward of each update."""
    import torch

    from dm_control_torch import suite
    from dm_control_torch.rl import ppo

    env = suite.load_batch("cartpole", "swingup", device=device,
                           dtype=torch.float32)
    cfg = ppo.PPOConfig(steps_per_batch=16, num_minibatches=4,
                        update_epochs=2)
    train_step, opt = ppo.make_train_step(env, cfg)
    generator = torch.Generator(device=env.model.device).manual_seed(0)
    state = ppo.init_train_state(env, generator, batch, opt)
    rewards = []
    for i in range(updates):
        state, metrics = train_step(state)
        rewards.append(float(metrics["mean_reward"]))
        if i % 5 == 0 or i == updates - 1:
            print(f"update {i}: mean_reward {rewards[-1]:.5f}")
    print(f"suite smoke: mean_reward {rewards[0]:.5f} -> {rewards[-1]:.5f}")
    return rewards


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--updates", type=int, default=20,
                        help="PPO updates to run.")
    parser.add_argument("--batch", type=int, default=256,
                        help="Parallel environments.")
    parser.add_argument("--device", default="cuda",
                        help="Where the suite smoke runs.")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if _gym_available():
        return run_gym_smoke(args.updates, args.batch)
    print("gym/Box2D not installed; running the suite fallback smoke "
          "(same learner loop, cartpole instead of BipedalWalker).")
    return run_suite_smoke(args.updates, args.batch, args.device)


if __name__ == "__main__":
    main()
