"""Soccer explorer (counterpart of
``dm_control_tpu/locomotion/soccer/explore.py``; reference:
dm_control/locomotion/soccer/explore.py).

    python -m dm_control_torch.locomotion.soccer.explore --team_size=2
"""

from __future__ import annotations

import argparse

import numpy as np

from dm_control_torch import viewer
from dm_control_torch.locomotion import soccer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--team_size", type=int, default=2,
                        help="Players per team (1-11).")
    parser.add_argument("--time_limit", type=float, default=45.0,
                        help="Episode time limit in seconds.")
    parser.add_argument("--walker_type", default="BOXHEAD",
                        choices=[t.name for t in soccer.WalkerType],
                        help="Walker type to instantiate.")
    parser.add_argument("--terminate_on_goal", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="End the episode when a goal is scored.")
    parser.add_argument("--device", default="cuda",
                        help="Where the physics runs and renders.")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    env = soccer.load(
        team_size=args.team_size,
        time_limit=args.time_limit,
        walker_type=soccer.WalkerType[args.walker_type],
        terminate_on_goal=args.terminate_on_goal,
        device=args.device)

    def random_policy(time_step):
        del time_step
        specs = env.task.action_spec_per_player(env.physics)
        return [np.random.uniform(s.minimum, s.maximum, s.shape)
                for s in specs]

    return viewer.launch(env, policy=random_policy)


if __name__ == "__main__":
    main()
