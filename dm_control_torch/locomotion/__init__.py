"""Locomotion on PyTorch (counterpart of ``dm_control_tpu/locomotion/``).

Two families of tasks, each on both paths: soccer (``soccer.load``, a
BoxHead match through ``composer.Environment`` on a pitch drawn every
episode; ``soccer.load_batch``, thousands of matches on a fixed pitch,
one reward per player) and mocap tracking
(``tasks.reference_pose.MultiClipMocapTracking`` with the rolling ball or
the CMU 2020 humanoid on a ``Floor``, through ``composer.Environment`` or
``composer.compile_task``).  The walkers, the arenas, the ball and the
pitch are composer entities that build their MJCF trees, which the port
compiles.  The other walkers, arenas and tasks, the mocap file loaders
and the soccer camera are not ported yet (ROADMAP A5.4, A5.5, A6).
"""
