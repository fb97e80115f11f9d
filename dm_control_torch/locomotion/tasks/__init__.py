"""Locomotion tasks (counterpart of ``dm_control_tpu/locomotion/tasks/``):
mocap tracking (host and batched), and on the host the corridor,
go-to-target, escape, maze and two-touch tasks."""

from dm_control_torch.locomotion.tasks.corridors import RunThroughCorridor  # noqa: F401
from dm_control_torch.locomotion.tasks.go_to_target import GoToTarget  # noqa: F401
from dm_control_torch.locomotion.tasks.escape import Escape  # noqa: F401
from dm_control_torch.locomotion.tasks.random_goal_maze import (  # noqa: F401
    ManyGoalsMaze, ManyHeterogeneousGoalsMaze, NullGoalMaze,
    RepeatSingleGoalMaze, RepeatSingleGoalMazeAugmentedWithTargets,
)
from dm_control_torch.locomotion.tasks.reach import TwoTouch, TwoTouchState  # noqa: F401
