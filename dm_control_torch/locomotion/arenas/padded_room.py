"""A square room whose outermost cells are always empty (counterpart of
``dm_control_tpu/locomotion/arenas/padded_room.py``; reference:
dm_control/locomotion/arenas/padded_room.py:22-81, a labmaze BaseMaze).

The grid follows the text mazes' conventions (``arenas/mazes.py``): an
``entity_layer`` of '*' wall, '.' floor, 'P' spawn and 'G' object
tokens, which ``regenerate()`` places anew inside the room; a
``MazeWithTargets`` builds its arena from it.
"""

from __future__ import annotations

import numpy as np

_PADDING = 4
_WALL = "*"
_FLOOR = "."
_EMPTY = " "
_SPAWN = "P"
_OBJECT = "G"


class PaddedRoom:
    """An empty square room with ``_PADDING``-cell margins
    (reference padded_room.py:22)."""

    def __init__(self, room_size: int, num_objects: int = 0,
                 random_state=None, pad_with_walls: bool = True,
                 num_agent_spawn_positions: int = 1):
        self._room_size = room_size
        self._num_objects = num_objects
        self._num_spawns = num_agent_spawn_positions
        self._random_state = random_state or np.random
        n = room_size + _PADDING
        self._grid = np.full((n, n), _FLOOR)
        if pad_with_walls:
            self._grid[0, :] = _WALL
            self._grid[-1, :] = _WALL
            self._grid[:, 0] = _WALL
            self._grid[:, -1] = _WALL
        self.regenerate()

    def regenerate(self) -> None:
        self._grid[1:-1, 1:-1] = _EMPTY
        chosen = self._random_state.choice(
            self._room_size * self._room_size,
            self._num_objects + self._num_spawns, replace=False)
        for i, cell in enumerate(chosen):
            token = _SPAWN if i < self._num_spawns else _OBJECT
            y, x = cell // self._room_size, cell % self._room_size
            self._grid[y + _PADDING // 2, x + _PADDING // 2] = token

    @property
    def entity_layer(self) -> str:
        return "\n".join("".join(row) for row in self._grid) + "\n"

    @property
    def variations_layer(self) -> str:
        n = self._room_size + _PADDING
        return "\n".join(_FLOOR * n for _ in range(n)) + "\n"

    @property
    def width(self) -> int:
        return self._room_size + _PADDING

    @property
    def height(self) -> int:
        return self._room_size + _PADDING
