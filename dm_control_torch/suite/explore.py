"""Interactive suite explorer (counterpart of
``dm_control_tpu/suite/explore.py``; reference: dm_control/suite/explore.py).

    python -m dm_control_torch.suite.explore \
        --environment_name=cartpole.swingup
"""

from __future__ import annotations

import argparse

import numpy as np

from dm_control_torch import suite, viewer
from dm_control_torch.suite.wrappers import action_noise

_ALL_NAMES = [".".join(dt) for dt in suite.ALL_TASKS]


def prompt_environment_name(prompt, values):
    """Asks until one of ``values`` is typed (reference explore.py:55-63)."""
    name = None
    while not name:
        name = input(prompt)
        if name not in values:
            print(f"{name!r} is not a valid environment name.")
            name = None
    return name


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--environment_name", choices=_ALL_NAMES, default=None,
        help="Optional 'domain_name.task_name' pair specifying the "
             "environment to load. If unspecified a prompt appears.")
    parser.add_argument("--timeout", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="Whether episodes should have a time limit.")
    parser.add_argument("--action_noise", type=float, default=0.0,
                        help="Std of Gaussian action noise as a fraction of "
                             "each action dimension's range (0 = none).")
    parser.add_argument("--device", default="cuda",
                        help="Where the physics runs and renders.")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    name = args.environment_name
    if name is None:
        print("\n".join(_ALL_NAMES))
        name = prompt_environment_name(
            "Please select an environment name: ", _ALL_NAMES)
    domain, task = name.split(".")
    task_kwargs = {}
    if not args.timeout:
        task_kwargs["time_limit"] = float("inf")
    env = suite.load(domain, task, task_kwargs=task_kwargs,
                     device=args.device)
    if args.action_noise > 0:
        env = action_noise.Wrapper(env, scale=args.action_noise)

    spec = env.action_spec()
    rng = np.random.RandomState(0)

    def random_policy(time_step):
        del time_step
        return rng.uniform(spec.minimum, spec.maximum, spec.shape)

    return viewer.launch(env, policy=random_policy)


if __name__ == "__main__":
    main()
