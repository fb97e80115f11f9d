"""Locomotion on PyTorch: the batched paths.

Counterpart of ``dm_control_tpu/locomotion/`` for the two families of
tasks that run batched (``composer.BatchableTask``): soccer
(``soccer.load_batch``: BoxHead teams on a fixed pitch, one reward per
player) and mocap tracking (``tasks.reference_pose.MultiClipMocapTracking``
through ``composer.compile_task``, with the rolling ball or the CMU 2020
humanoid).  Walkers, arenas, the ball and the pitch are names and
geometry: their compiled models are checked-in assets
(``locomotion/assets/``).  Composer's host path, the other walkers,
arenas and tasks are not ported yet (ROADMAP A5).
"""

import os

ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "assets")


def asset_path(asset: str) -> str:
    """The compiled model ``locomotion/assets/<asset>.npz``."""
    return os.path.join(ASSET_DIR, asset + ".npz")
