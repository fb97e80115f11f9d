"""Locomotion on PyTorch (counterpart of ``dm_control_tpu/locomotion/``).

Two families of tasks on both paths: soccer (``soccer.load``, a match of
BoxHead, ant or humanoid players through ``composer.Environment`` on a
pitch drawn every episode; ``soccer.load_batch``, thousands of BoxHead
matches on a fixed pitch, one reward per player) and mocap tracking
(``tasks.reference_pose.MultiClipMocapTracking`` with the rolling ball or
the CMU 2020 humanoid on a ``Floor``, through ``composer.Environment`` or
``composer.compile_task``).  On the host path, the example environments
(``examples.basic``): the CMU 2019 humanoid and the rat in corridors of
gaps or walls, going to a target, foraging in mazes, escaping a bowl and
touching a target twice.  The walkers, the arenas, the props, the ball
and the pitch are composer entities that build their MJCF trees, which
the port compiles; ``walkers.rescale`` and ``walkers.scaled_actuators``
edit a walker's tree, and ``arenas.PaddedRoom`` lays out a room for the
mazes; ``soccer.MultiplayerTrackingCamera`` follows a match and renders
it.  Clips come from HDF5 or protobuf clip files
(``mocap.loader``) or are made (``synthetic_walking_trajectory``);
``tasks.reference_pose.datasets`` names the CMU subsets;
``examples.cmu_2020_tracking.cmu_humanoid_tracking`` is the CMU 2020
humanoid tracking walk_tiny, and ``walkers.initializers.mocap`` starts a
walker at a clip's frame.
"""
