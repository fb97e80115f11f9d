"""Preconfigured locomotion environments (counterpart of
``dm_control_tpu/locomotion/examples/``): ``basic`` serves the nine
corridor, go-to-target, maze, bowl and two-touch environments of the CMU
2019 humanoid and the rat through ``composer.Environment``, and
``explore`` opens any of them in the viewer.
``cmu_2020_tracking.cmu_humanoid_tracking`` is the CMU 2020 humanoid
tracking the walk_tiny clips.
"""
