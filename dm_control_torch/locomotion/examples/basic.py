"""Preconfigured locomotion environments (counterpart of
``dm_control_tpu/locomotion/examples/basic.py``; reference:
dm_control/locomotion/examples/basic_cmu_2019.py:34-164 and
basic_rodent_2020.py).

Each function builds its task's entity tree, which
``composer.Environment`` compiles onto ``device`` (the card unless the
caller asks for another, ``device="cpu"``; without CUDA the default
raises before anything is built) in ``dtype``.  As in the JAX package,
the corridors draw their layout from numpy's global state when they are
built, and ``random_state`` seeds the episodes.
"""

from __future__ import annotations

import functools

import torch

from dm_control_torch import composer
from dm_control_torch.composer.variation import distributions
from dm_control_torch.locomotion.arenas import (
    Bowl, Floor, GapsCorridor, MazeWithTargets, TextMaze, WallsCorridor,
)
from dm_control_torch.locomotion.props.target_sphere import TargetSphere
from dm_control_torch.locomotion.tasks import (
    Escape, GoToTarget, ManyGoalsMaze, ManyHeterogeneousGoalsMaze,
    RunThroughCorridor, TwoTouch,
)
from dm_control_torch.locomotion.walkers.cmu_humanoid import (
    CMUHumanoidPositionControlled,
)
from dm_control_torch.locomotion.walkers.rodent import Rat
from dm_control_torch.suite import check_device


def _environment(build):
    """``build()`` -> (task, time limit) as an entry point
    ``name(random_state=None, *, device="cuda", dtype=torch.float64)``
    that returns the task's ``composer.Environment``."""

    @functools.wraps(build)
    def load(random_state=None, *, device="cuda",
             dtype: torch.dtype = torch.float64):
        check_device(f"examples.basic.{build.__name__}", device)
        task, time_limit = build()
        return composer.Environment(task, time_limit=time_limit,
                                    random_state=random_state, device=device,
                                    dtype=dtype)

    return load


@_environment
def cmu_humanoid_run_walls():
    """CMU humanoid running through a walls corridor
    (reference basic_cmu_2019.py:34)."""
    walker = CMUHumanoidPositionControlled()
    arena = WallsCorridor(
        wall_gap=4.0, wall_width=distributions.Uniform(1, 7),
        wall_height=3.0, corridor_width=10, corridor_length=100)
    task = RunThroughCorridor(
        walker=walker, arena=arena, walker_spawn_position=(0.5, 0, 1.3),
        target_velocity=3.0, physics_timestep=0.005,
        control_timestep=0.03)
    return task, 30


@_environment
def cmu_humanoid_run_gaps():
    """CMU humanoid running over gaps (reference basic_cmu_2019.py:70)."""
    walker = CMUHumanoidPositionControlled()
    arena = GapsCorridor(
        platform_length=distributions.Uniform(0.3, 2.5),
        gap_length=distributions.Uniform(0.5, 1.25),
        corridor_width=10, corridor_length=100)
    task = RunThroughCorridor(
        walker=walker, arena=arena, walker_spawn_position=(0.5, 0, 1.3),
        target_velocity=3.0, physics_timestep=0.005,
        control_timestep=0.03)
    return task, 30


@_environment
def cmu_humanoid_go_to_target():
    """CMU humanoid go-to-target (reference basic_cmu_2019.py:104)."""
    walker = CMUHumanoidPositionControlled()
    task = GoToTarget(walker=walker, arena=Floor(),
                      physics_timestep=0.005, control_timestep=0.03)
    return task, 30


_MAZE_LAYOUT = """*********
*P....*.*
*.***.*.*
*.*G..*G*
*.*.***.*
*...*...*
*.*.*.*G*
*G*.....*
*********"""


@_environment
def cmu_humanoid_maze_forage():
    """CMU humanoid foraging a maze for target spheres
    (reference basic_cmu_2019.py:127 maze_forage)."""
    walker = CMUHumanoidPositionControlled()
    arena = MazeWithTargets(TextMaze(_MAZE_LAYOUT), xy_scale=3.0)
    task = ManyGoalsMaze(
        walker=walker, maze_arena=arena,
        target_builder=lambda name: TargetSphere(radius=0.4, name=name),
        target_reward_scale=1.0, physics_timestep=0.005,
        control_timestep=0.03)
    return task, 30


@_environment
def cmu_humanoid_heterogeneous_forage():
    """Two target types with different rewards
    (reference basic_cmu_2019.py:164)."""
    walker = CMUHumanoidPositionControlled()
    arena = MazeWithTargets(TextMaze(_MAZE_LAYOUT), xy_scale=3.0)
    task = ManyHeterogeneousGoalsMaze(
        walker=walker, maze_arena=arena,
        target_builders=[
            lambda name: TargetSphere(radius=0.4, name=name),
            lambda name: TargetSphere(radius=0.25, name=name),
        ],
        target_type_rewards=[1.0, 10.0],
        target_type_proportions=[2, 1],
        physics_timestep=0.005, control_timestep=0.03)
    return task, 30


@_environment
def rodent_escape_bowl():
    """Rodent escaping a bowl (reference basic_rodent_2020.py:37)."""
    task = Escape(walker=Rat(), arena=Bowl(size=(20, 20)),
                  walker_spawn_position=(0, 0, 0.2),
                  physics_timestep=0.001, control_timestep=0.02)
    return task, 20


@_environment
def rodent_run_gaps():
    """Rodent running over gaps (reference basic_rodent_2020.py:62)."""
    walker = Rat()
    arena = GapsCorridor(
        platform_length=distributions.Uniform(0.4, 0.8),
        gap_length=distributions.Uniform(0.05, 0.2),
        corridor_width=2, corridor_length=40)
    task = RunThroughCorridor(
        walker=walker, arena=arena, walker_spawn_position=(0.5, 0, 0.2),
        target_velocity=1.0, physics_timestep=0.001,
        control_timestep=0.02)
    return task, 30


@_environment
def rodent_maze_forage():
    """Rodent maze foraging (reference basic_rodent_2020.py:97)."""
    walker = Rat()
    arena = MazeWithTargets(TextMaze(_MAZE_LAYOUT), xy_scale=0.5,
                            z_height=0.3)
    task = ManyGoalsMaze(
        walker=walker, maze_arena=arena,
        target_builder=lambda name: TargetSphere(radius=0.05, name=name),
        target_reward_scale=1.0, physics_timestep=0.001,
        control_timestep=0.02)
    return task, 30


@_environment
def rodent_two_touch():
    """Rodent two-tap task (reference basic_rodent_2020.py:140)."""
    task = TwoTouch(walker=Rat(), arena=Floor(size=(2, 2)),
                    target_type_rewards=(1.0,),
                    target_area=(0.5, 0.5), z_height=0.06,
                    physics_timestep=0.001, control_timestep=0.02)
    return task, 15
