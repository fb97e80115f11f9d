"""Locomotion arenas (counterpart of
``dm_control_tpu/locomotion/arenas/``): the floor, the corridors, the
bowl, the mazes, the wall covering and the padded room (a grid that a
``MazeWithTargets`` builds its arena from)."""

from dm_control_torch.locomotion.arenas.floors import Floor  # noqa: F401
from dm_control_torch.locomotion.arenas.corridors import (  # noqa: F401
    EmptyCorridor, GapsCorridor, WallsCorridor,
)
from dm_control_torch.locomotion.arenas.bowl import Bowl  # noqa: F401
from dm_control_torch.locomotion.arenas.mazes import (  # noqa: F401
    MazeWithTargets, TextMaze,
)
from dm_control_torch.locomotion.arenas import covering  # noqa: F401
from dm_control_torch.locomotion.arenas.padded_room import (  # noqa: F401
    PaddedRoom,
)
