"""Locomotion examples explorer (counterpart of
``dm_control_tpu/locomotion/examples/explore.py``; reference:
dm_control/locomotion/examples/explore.py).

    python -m dm_control_torch.locomotion.examples.explore \
        --environment=cmu_humanoid_run_gaps
"""

from __future__ import annotations

import argparse
import functools

from dm_control_torch import viewer
from dm_control_torch.locomotion.examples import basic

_LOADERS = {name: getattr(basic, name) for name in dir(basic)
            if name.startswith(("cmu_humanoid_", "rodent_"))}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--environment", default="cmu_humanoid_run_gaps",
                        choices=sorted(_LOADERS),
                        help="Which example environment to load.")
    parser.add_argument("--device", default="cuda",
                        help="Where the physics runs and renders.")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return viewer.launch(environment_loader=functools.partial(
        _LOADERS[args.environment], device=args.device))


if __name__ == "__main__":
    main()
