"""Wall-covering: merge maze wall cells into a small set of rectangles.

Reference: dm_control/locomotion/arenas/covering.py — a greedy algorithm
that covers the '*' cells of a text maze with axis-aligned rectangles so
each becomes one box geom.

Counterpart of ``dm_control_tpu/locomotion/arenas/covering.py``.
"""

from __future__ import annotations

import collections
from typing import List

import numpy as np

GridCoordinates = collections.namedtuple("GridCoordinates", ("y", "x"))


class MazeWall:
    """A rectangular wall block in grid coordinates: [start, end)."""

    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start = GridCoordinates(*start)
        self.end = GridCoordinates(*end)

    @property
    def width(self):
        return self.end.x - self.start.x

    @property
    def height(self):
        return self.end.y - self.start.y

    def __repr__(self):
        return f"MazeWall({tuple(self.start)}, {tuple(self.end)})"

    def __eq__(self, other):
        return (isinstance(other, MazeWall)
                and self.start == other.start and self.end == other.end)

    def __hash__(self):
        return hash((self.start, self.end))


def make_walls(text_maze, wall_char: str = "*") -> List[MazeWall]:
    """Greedy rectangle covering of ``wall_char`` cells.

    ``text_maze`` is either a newline-separated string or an object with
    an ``entity_layer`` attribute (grid of single characters).
    """
    layer = getattr(text_maze, "entity_layer", text_maze)
    if isinstance(layer, str):
        rows = [r for r in layer.splitlines() if r]
        grid = np.array([list(r) for r in rows])
    else:
        grid = np.asarray(layer)
    covered = np.zeros(grid.shape, bool)
    is_wall = grid == wall_char
    h, w = grid.shape
    walls: List[MazeWall] = []
    for y in range(h):
        for x in range(w):
            if not is_wall[y, x] or covered[y, x]:
                continue
            # grow right as far as possible
            x2 = x
            while (x2 + 1 < w and is_wall[y, x2 + 1]
                   and not covered[y, x2 + 1]):
                x2 += 1
            # grow down while every cell in the row span is uncovered wall
            y2 = y
            while (y2 + 1 < h
                   and is_wall[y2 + 1, x:x2 + 1].all()
                   and not covered[y2 + 1, x:x2 + 1].any()):
                y2 += 1
            covered[y:y2 + 1, x:x2 + 1] = True
            walls.append(MazeWall((y, x), (y2 + 1, x2 + 1)))
    return walls
