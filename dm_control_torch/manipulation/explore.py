"""Interactive manipulation-task explorer (counterpart of
``dm_control_tpu/manipulation/explore.py``; reference:
dm_control/manipulation/explore.py).

    python -m dm_control_torch.manipulation.explore \
        --environment_name=reach_site_features
"""

from __future__ import annotations

import argparse

import numpy as np

from dm_control_torch import manipulation, viewer
from dm_control_torch.suite.explore import prompt_environment_name


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--environment_name", choices=list(manipulation.ALL),
                        default=None,
                        help="Optional name of an environment to load. If "
                             "unspecified a prompt appears.")
    parser.add_argument("--device", default="cuda",
                        help="Where the physics runs and renders.")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    name = args.environment_name
    if name is None:
        print("\n".join(manipulation.ALL))
        name = prompt_environment_name(
            "Please select an environment name: ", manipulation.ALL)
    env = manipulation.load(name, device=args.device)
    spec = env.action_spec()
    rng = np.random.RandomState(0)

    def random_policy(time_step):
        del time_step
        return rng.uniform(spec.minimum, spec.maximum, spec.shape)

    return viewer.launch(env, policy=random_policy)


if __name__ == "__main__":
    main()
