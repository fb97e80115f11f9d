"""Plays a saved action file back through the viewer (counterpart of
``dm_control_tpu/scripts/visualize.py``; reference:
dm_control/scripts/visualize.py): the file's actions, then zeros.  The
physics runs on ``--device``, the card by default, in float32 (the JAX
script runs at JAX's default precision):

    python -m dm_control_torch.scripts.visualize \
        --ref_actions_path=opt_acts_0.npy --domain=cartpole --task=swingup
"""

from __future__ import annotations

import argparse

import numpy as np


def playback_policy(actions):
    """The viewer's policy: ``actions[t]`` at the t-th call, zeros after
    the last."""
    state = {"t": 0}

    def policy(time_step):
        t = state["t"]
        state["t"] = t + 1
        if t < len(actions):
            return actions[t]
        return np.zeros_like(actions[0])

    return policy


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ref_actions_path", default="opt_acts_0.npy",
                        help="Saved actions to play back.")
    parser.add_argument("--domain", default="cartpole", help="Suite domain.")
    parser.add_argument("--task", default="swingup", help="Suite task.")
    parser.add_argument("--seed", type=int, default=0, help="Env seed.")
    parser.add_argument("--device", default="cuda",
                        help="Where the physics runs.")
    return parser.parse_args(argv)


def main(argv=None):
    import torch

    from dm_control_torch import suite, viewer

    args = parse_args(argv)
    actions = np.load(args.ref_actions_path)

    def loader():
        return suite.load(args.domain, args.task,
                          task_kwargs={"random": args.seed},
                          device=args.device, dtype=torch.float32)

    return viewer.launch(loader, policy=playback_policy(actions))


if __name__ == "__main__":
    main()
