"""AMC mocap playback on humanoid_CMU (counterpart of
``dm_control_tpu/suite/demos/mocap_demo.py``; reference:
dm_control/suite/demos/mocap_demo.py).

    python -m dm_control_torch.suite.demos.mocap_demo --filename=clip.amc
    python -m dm_control_torch.suite.demos.mocap_demo --filename=clip.amc \
        --device=cpu

The clip is converted to humanoid_CMU's joints at the physics' timestep
(``suite/utils/parse_amc.py``) and each frame's state is set on a
``Physics`` of the environment's model, on the card unless ``--device``
names another.  (The JAX package's demo sets it on ``env.physics``, a
view with no ``reset_context``, and stops there with an AttributeError.)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dm_control_torch import suite
from dm_control_torch.physics.physics import Physics
from dm_control_torch.suite.utils import parse_amc


def playback(filename, max_num_frames=90, *, device="cuda",
             dtype: torch.dtype = torch.float64):
    """Plays the first ``max_num_frames`` frames of the AMC file back on
    ``suite.load("humanoid_CMU", "stand")``, printing the clip's length
    and the head's height every 30 frames.  Returns the converted clip and
    the head's height at every frame played."""
    env = suite.load("humanoid_CMU", "stand", device=device, dtype=dtype)
    dt = float(env.physics.model.opt.timestep)
    converted = parse_amc.convert(filename, env.physics, dt)
    n = min(converted.qpos.shape[1] - 1, max_num_frames)
    print(f"clip: {converted.qpos.shape[1]} frames at dt={dt}")

    env.reset()
    physics = Physics(env.physics.model)
    heights = []
    for i in range(n):
        with physics.reset_context():
            physics.set_state(np.concatenate(
                [converted.qpos[:, i], converted.qvel[:, i]]))
        h = float(physics.named_field("xpos", "head")[2]) \
            if "head" in physics.model.names.body else 0.0
        heights.append(h)
        if i % 30 == 0:
            print(f"frame {i}: head height {h:.3f}")
    print("playback done")
    return converted, np.asarray(heights)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--filename", default=None,
                        help="amc file to be converted.")
    parser.add_argument("--max_num_frames", type=int, default=90,
                        help="Maximum number of frames for playback.")
    parser.add_argument("--device", default="cuda",
                        help="Where the physics runs.")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.filename is None:
        raise SystemExit("--filename required (a CMU .amc clip; see "
                         "mocap.cs.cmu.edu)")
    playback(args.filename, args.max_num_frames, device=args.device)


if __name__ == "__main__":
    main()
