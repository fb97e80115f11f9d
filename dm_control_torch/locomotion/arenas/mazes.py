"""Maze arenas with target/spawn tokens.

Reference: dm_control/locomotion/arenas/mazes.py (MazeWithTargets over a
labmaze text grid).  labmaze is an external dependency of the reference;
here ``TextMaze`` provides the same grid contract — an ``entity_layer``
of characters ('*' wall, '.' floor, 'P' spawn, 'G' target) plus
``regenerate()`` — with a built-in randomized-DFS generator for random
layouts.

Counterpart of ``dm_control_tpu/locomotion/arenas/mazes.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from dm_control_torch.composer.arena import Arena
from dm_control_torch.locomotion.arenas import covering

_WALL_CHAR = "*"
_FLOOR_CHAR = "."
_SPAWN_TOKEN = "P"
_TARGET_TOKEN = "G"


class TextMaze:
    """A text-grid maze (labmaze.FixedMazeWithRandomGoals equivalent).

    With ``entity_layer`` given, the layout is fixed and ``regenerate``
    only reshuffles spawn/target tokens onto random floor cells when
    ``num_spawns``/``num_objects`` are set.  Without it, ``regenerate``
    carves a fresh random maze (randomized DFS on odd cells).
    """

    def __init__(self, entity_layer: Optional[str] = None,
                 height: int = 9, width: int = 9,
                 num_spawns: Optional[int] = None,
                 num_objects: Optional[int] = None,
                 random_seed: Optional[int] = None):
        self._fixed = entity_layer is not None
        self._height = height
        self._width = width
        self._num_spawns = num_spawns
        self._num_objects = num_objects
        if entity_layer is not None:
            rows = [r for r in entity_layer.splitlines() if r]
            self._grid = np.array([list(r) for r in rows])
        else:
            self._grid = None
        self.regenerate(np.random.RandomState(random_seed))

    @property
    def entity_layer(self) -> str:
        return "\n".join("".join(row) for row in self._grid) + "\n"

    @property
    def height(self) -> int:
        return self._grid.shape[0]

    @property
    def width(self) -> int:
        return self._grid.shape[1]

    def regenerate(self, random_state=None) -> None:
        random_state = random_state or np.random.RandomState()
        if not self._fixed:
            self._grid = _carve_maze(self._height, self._width,
                                     random_state)
        else:
            # strip movable tokens back to floor before re-placing
            if self._num_spawns is not None or self._num_objects is not None:
                self._grid = np.where(
                    np.isin(self._grid, (_SPAWN_TOKEN, _TARGET_TOKEN)),
                    _FLOOR_CHAR, self._grid)
        ns = self._num_spawns
        no = self._num_objects
        if ns is None and not self._fixed:
            ns = 1
        if no is None and not self._fixed:
            no = 1
        if ns or no:
            free = np.argwhere(self._grid == _FLOOR_CHAR)
            order = random_state.permutation(len(free))
            k = 0
            for _ in range(ns or 0):
                y, x = free[order[k]]
                self._grid[y, x] = _SPAWN_TOKEN
                k += 1
            for _ in range(no or 0):
                y, x = free[order[k]]
                self._grid[y, x] = _TARGET_TOKEN
                k += 1

    def find_tokens(self, token: str):
        return [tuple(ij) for ij in np.argwhere(self._grid == token)]


def _carve_maze(height: int, width: int, random_state) -> np.ndarray:
    """Randomized-DFS maze on odd cells (classic recursive backtracker)."""
    height += (height + 1) % 2  # force odd
    width += (width + 1) % 2
    grid = np.full((height, width), _WALL_CHAR)
    start = (1, 1)
    stack = [start]
    grid[start] = _FLOOR_CHAR
    while stack:
        y, x = stack[-1]
        neighbors = [(y + dy, x + dx, y + dy // 2, x + dx // 2)
                     for dy, dx in ((2, 0), (-2, 0), (0, 2), (0, -2))
                     if 0 < y + dy < height - 1 and 0 < x + dx < width - 1
                     and grid[y + dy, x + dx] == _WALL_CHAR]
        if not neighbors:
            stack.pop()
            continue
        ny, nx, wy, wx = neighbors[random_state.randint(len(neighbors))]
        grid[wy, wx] = _FLOOR_CHAR
        grid[ny, nx] = _FLOOR_CHAR
        stack.append((ny, nx))
    return grid


class MazeWithTargets(Arena):
    """Builds wall/floor geoms from a TextMaze and exposes world-frame
    spawn/target positions (reference mazes.py:38)."""

    def _build(self, maze, xy_scale: float = 2.0, z_height: float = 2.0,
               name: str = "maze"):
        super()._build(name=name)
        self._maze = maze
        self._xy_scale = xy_scale
        self._z_height = z_height
        wb = self._mjcf_root.first("worldbody")
        half_w = maze.width * xy_scale / 2
        half_h = maze.height * xy_scale / 2
        wb.add("geom", name="floor", type="plane",
               size=f"{half_w} {half_h} .1")
        self._wall_elems = []
        self._rebuild_walls()

    def _rebuild_walls(self):
        wb = self._mjcf_root.first("worldbody")
        for e in self._wall_elems:
            wb.children.remove(e)
        self._wall_elems = []
        s = self._xy_scale
        hz = self._z_height / 2
        for i, wall in enumerate(covering.make_walls(self._maze)):
            cy = (wall.start.y + wall.end.y) / 2 - self._maze.height / 2
            cx = (wall.start.x + wall.end.x) / 2 - self._maze.width / 2
            e = wb.add("geom", name=f"wall_{i}", type="box",
                       pos=f"{cx * s} {-cy * s} {hz}",
                       size=f"{wall.width * s / 2} "
                            f"{wall.height * s / 2} {hz}")
            self._wall_elems.append(e)

    @property
    def maze(self):
        return self._maze

    @property
    def xy_scale(self):
        return self._xy_scale

    def regenerate(self, random_state=None) -> None:
        """Regenerates the text maze and rebuilds wall geoms; the new
        walls take effect when the tree is compiled again (no task of
        the port calls it per episode)."""
        self._maze.regenerate(random_state)
        self._rebuild_walls()

    def grid_to_world_positions(self, grid_positions: Sequence[Tuple]):
        s = self._xy_scale
        out = []
        for y, x in grid_positions:
            out.append(np.array([(x + 0.5 - self._maze.width / 2) * s,
                                 -(y + 0.5 - self._maze.height / 2) * s,
                                 0.0]))
        return out

    def world_to_grid_positions(self, world_positions):
        s = self._xy_scale
        out = []
        for p in world_positions:
            x = p[0] / s + self._maze.width / 2 - 0.5
            y = -(p[1] / s - self._maze.height / 2) - 0.5
            out.append(np.array([y, x]))
        return out

    def find_token_grid_positions(self, tokens):
        return {t: self._maze.find_tokens(t) for t in tokens}

    @property
    def spawn_positions(self):
        return self.grid_to_world_positions(
            self._maze.find_tokens(_SPAWN_TOKEN))

    @property
    def target_positions(self):
        return self.grid_to_world_positions(
            self._maze.find_tokens(_TARGET_TOKEN))
