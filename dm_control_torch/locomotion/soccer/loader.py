"""Soccer's entry points (counterpart of
``dm_control_tpu/locomotion/soccer/loader.py``; reference:
dm_control/locomotion/soccer/__init__.py:48-170)."""

from __future__ import annotations

import numpy as np
import torch

from dm_control_torch import composer
from dm_control_torch.composer.batch import compile_task
from dm_control_torch.locomotion.soccer.pitch import (
    MINI_FOOTBALL_GOAL_SIZE, MINI_FOOTBALL_MAX_AREA_PER_HUMANOID,
    MINI_FOOTBALL_MIN_AREA_PER_HUMANOID, Pitch, RandomizedPitch,
)
from dm_control_torch.locomotion.soccer.soccer_ball import (
    SoccerBall, regulation_soccer_ball,
)
from dm_control_torch.locomotion.soccer.task import (  # noqa: F401
    MultiturnTask, Task, WalkerType, standard_players, walker_type_of,
)
from dm_control_torch.suite import check_device


def _area_to_size(area, aspect_ratio=0.75):
    """(half-length, half-width) of a pitch of ``area`` and aspect
    ratio."""
    return np.sqrt([area / aspect_ratio, area * aspect_ratio]) / 2.0


def load(team_size=2, time_limit=45.0, random_state=None,
         disable_walker_contacts=False, enable_field_box=False,
         keep_aspect_ratio=False, terminate_on_goal=True,
         walker_type=WalkerType.BOXHEAD, pitch_size=None, *,
         device="cuda", dtype: torch.dtype = torch.float64):
    """A ``team_size``-vs-``team_size`` match of ``walker_type`` players
    (a ``WalkerType`` or its name: BoxHead, ant or humanoid) as a
    ``composer.Environment`` on ``device`` in ``dtype`` (the card unless
    the caller asks for another, ``device="cpu"``; without CUDA the
    default raises).  By default the pitch is a ``RandomizedPitch``
    drawn and compiled anew every episode, of (32, 24) to (48, 36), or
    for humanoids of the mini-football areas per player with the
    mini-football goals and the regulation ball; ``pitch_size`` pins a
    ``Pitch`` of that size, compiled once.  A goal ends the episode unless
    ``terminate_on_goal`` is False (``MultiturnTask``)."""
    walker_type = walker_type_of(walker_type)
    if not 1 <= team_size <= 11:
        raise ValueError(
            f"team_size must be between 1 and 11, got {team_size}")
    check_device(f"soccer.load(team_size={team_size})", device)
    goal_size = None
    min_size, max_size = (32, 24), (48, 36)
    ball = SoccerBall()
    if walker_type == WalkerType.HUMANOID:
        goal_size = MINI_FOOTBALL_GOAL_SIZE
        num_walkers = team_size * 2
        min_size = _area_to_size(
            MINI_FOOTBALL_MIN_AREA_PER_HUMANOID * num_walkers)
        max_size = _area_to_size(
            MINI_FOOTBALL_MAX_AREA_PER_HUMANOID * num_walkers)
        ball = regulation_soccer_ball()
    if pitch_size is not None:
        arena = Pitch(size=pitch_size, goal_size=goal_size,
                      field_box=enable_field_box)
        recompile = False
    else:
        arena = RandomizedPitch(
            min_size=min_size, max_size=max_size,
            keep_aspect_ratio=keep_aspect_ratio, goal_size=goal_size,
            field_box=enable_field_box)
        recompile = True
    task_factory = Task if terminate_on_goal else MultiturnTask
    task = task_factory(
        players=standard_players(team_size, walker_type), arena=arena,
        ball=ball, disable_walker_contacts=disable_walker_contacts)
    return composer.Environment(
        task, time_limit=time_limit, random_state=random_state,
        recompile_mjcf_every_episode=recompile, device=device, dtype=dtype)


def load_batch(team_size=2, time_limit=45.0, pitch_size=(12, 9),
               disable_walker_contacts=False, *, device="cuda",
               dtype: torch.dtype, autoreset=True, contact_cap=None,
               walker_type=WalkerType.BOXHEAD):
    """A ``BatchEnv`` of ``team_size``-vs-``team_size`` BoxHead soccer on a
    fixed pitch of half-size ``pitch_size``, its model compiled from the
    match's entity tree onto ``device`` in ``dtype``: one reward per
    player, (B, 2 * team_size); a goal ends the episode and the autoreset
    kicks off anew.  The device is the card unless the caller asks for
    another (``device="cpu"``); without CUDA the default raises.  A walker
    other than BoxHead raises ``NotImplementedError``: the batched hooks
    place slide roots and steer yaw, and the JAX package's ``load_batch``
    builds only BoxHead matches (``load`` runs the others).
    ``contact_cap`` goes to ``BatchEnv``."""
    walker_type = walker_type_of(walker_type)
    if walker_type != WalkerType.BOXHEAD:
        raise NotImplementedError(
            f"soccer.load_batch: the batched path builds BoxHead matches, "
            f"as the JAX package's load_batch does; {walker_type.name} "
            f"matches run through soccer.load")
    check_device(f"soccer.load_batch(team_size={team_size})", device)
    task = Task(players=standard_players(team_size),
                arena=Pitch(size=pitch_size, field_box=True),
                ball=SoccerBall(),
                disable_walker_contacts=disable_walker_contacts)
    return compile_task(task, device=device, dtype=dtype,
                        time_limit=time_limit, autoreset=autoreset,
                        contact_cap=contact_cap)
