"""Soccer's entry points (counterpart of
``dm_control_tpu/locomotion/soccer/loader.py``)."""

from __future__ import annotations

import enum

import torch

from dm_control_torch.composer.batch import compile_task
from dm_control_torch.locomotion.soccer.pitch import Pitch
from dm_control_torch.locomotion.soccer.soccer_ball import SoccerBall
from dm_control_torch.locomotion.soccer.task import Task, standard_players
from dm_control_torch.suite import check_device


class WalkerType(enum.Enum):
    BOXHEAD = 0
    ANT = 1
    HUMANOID = 2


def load(team_size=2, time_limit=45.0, random_state=None,
         disable_walker_contacts=False, enable_field_box=False,
         keep_aspect_ratio=False, terminate_on_goal=True,
         walker_type=WalkerType.BOXHEAD, pitch_size=None):
    """The single environment of a match: composer's host path, not
    ported yet."""
    raise NotImplementedError(
        "soccer.load: composer's host path (environment, task, "
        "observables, a randomized pitch) is not ported yet (ROADMAP A5); "
        "soccer.load_batch runs the batched match")


def load_batch(team_size=2, time_limit=45.0, pitch_size=(12, 9),
               disable_walker_contacts=False, *, device="cuda",
               dtype: torch.dtype, autoreset=True, contact_cap=None,
               walker_type=WalkerType.BOXHEAD):
    """A ``BatchEnv`` of ``team_size``-vs-``team_size`` BoxHead soccer on a
    fixed pitch, its model on ``device`` in ``dtype``: one reward per
    player, (B, 2 * team_size); a goal ends the episode and the autoreset
    kicks off anew.  The device is the card unless the caller asks for
    another (``device="cpu"``); without CUDA the default raises.  The
    checked-in models are 1 and 2 a side on the (12, 9) pitch with walker
    contacts on; others need the entity model builders (ROADMAP A9b), and
    so does a walker other than BoxHead, as in the JAX package's
    ``load_batch``.  ``contact_cap`` goes to ``BatchEnv``."""
    if isinstance(walker_type, str):
        walker_type = WalkerType[walker_type.upper()]
    if walker_type != WalkerType.BOXHEAD:
        raise NotImplementedError(
            f"soccer.load_batch: {walker_type.name} players need a compiled "
            f"model of their own (ROADMAP A9b); the batched match runs "
            f"BoxHead")
    task = Task(players=standard_players(team_size),
                arena=Pitch(size=pitch_size, field_box=True),
                ball=SoccerBall(),
                disable_walker_contacts=disable_walker_contacts)
    check_device(f"soccer.load_batch(team_size={team_size})", device)
    return compile_task(task, device=device, dtype=dtype,
                        time_limit=time_limit, autoreset=autoreset,
                        contact_cap=contact_cap)
