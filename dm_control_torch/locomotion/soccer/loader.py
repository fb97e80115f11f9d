"""Soccer's entry points (counterpart of
``dm_control_tpu/locomotion/soccer/loader.py``; reference:
dm_control/locomotion/soccer/__init__.py:48-170)."""

from __future__ import annotations

import enum

import torch

from dm_control_torch import composer
from dm_control_torch.composer.batch import compile_task
from dm_control_torch.locomotion.soccer.pitch import Pitch, RandomizedPitch
from dm_control_torch.locomotion.soccer.soccer_ball import SoccerBall
from dm_control_torch.locomotion.soccer.task import (
    MultiturnTask, Task, standard_players,
)
from dm_control_torch.suite import check_device


class WalkerType(enum.Enum):
    BOXHEAD = 0
    ANT = 1
    HUMANOID = 2


def _check_walker_type(walker_type, entry):
    """Raises ``NotImplementedError`` naming ROADMAP A5.5 for a walker
    type (a ``WalkerType`` or its name) other than BoxHead."""
    if isinstance(walker_type, str):
        walker_type = WalkerType[walker_type.upper()]
    if walker_type != WalkerType.BOXHEAD:
        raise NotImplementedError(
            f"soccer.{entry}: {walker_type.name} players are not ported yet "
            f"(ROADMAP A5.5); the port's matches are BoxHead")


def load(team_size=2, time_limit=45.0, random_state=None,
         disable_walker_contacts=False, enable_field_box=False,
         keep_aspect_ratio=False, terminate_on_goal=True,
         walker_type=WalkerType.BOXHEAD, pitch_size=None, *,
         device="cuda", dtype: torch.dtype = torch.float64):
    """A ``team_size``-vs-``team_size`` BoxHead match as a
    ``composer.Environment`` on ``device`` in ``dtype`` (the card unless
    the caller asks for another, ``device="cpu"``; without CUDA the
    default raises).  By default the pitch is a ``RandomizedPitch`` of
    (32, 24) to (48, 36), drawn and compiled anew every episode;
    ``pitch_size`` pins a ``Pitch`` of that size, compiled once.  A goal
    ends the episode unless ``terminate_on_goal`` is False
    (``MultiturnTask``).  ``walker_type`` ANT or HUMANOID raises
    ``NotImplementedError`` (ROADMAP A5.5)."""
    _check_walker_type(walker_type, "load")
    if not 1 <= team_size <= 11:
        raise ValueError(
            f"team_size must be between 1 and 11, got {team_size}")
    check_device(f"soccer.load(team_size={team_size})", device)
    if pitch_size is not None:
        arena = Pitch(size=pitch_size, field_box=enable_field_box)
        recompile = False
    else:
        arena = RandomizedPitch(
            min_size=(32, 24), max_size=(48, 36),
            keep_aspect_ratio=keep_aspect_ratio,
            field_box=enable_field_box)
        recompile = True
    task_factory = Task if terminate_on_goal else MultiturnTask
    task = task_factory(
        players=standard_players(team_size), arena=arena, ball=SoccerBall(),
        disable_walker_contacts=disable_walker_contacts)
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
    other than BoxHead raises ``NotImplementedError``, as the JAX
    package's ``load_batch`` builds only BoxHead matches.
    ``contact_cap`` goes to ``BatchEnv``."""
    _check_walker_type(walker_type, "load_batch")
    check_device(f"soccer.load_batch(team_size={team_size})", device)
    task = Task(players=standard_players(team_size),
                arena=Pitch(size=pitch_size, field_box=True),
                ball=SoccerBall(),
                disable_walker_contacts=disable_walker_contacts)
    return compile_task(task, device=device, dtype=dtype,
                        time_limit=time_limit, autoreset=autoreset,
                        contact_cap=contact_cap)
