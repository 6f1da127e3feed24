"""A drag of the reference point across the grid.

From ``start`` (fractions of the grid) each step moves every axis by
``step_min`` to ``step_max`` voxels, the seed drawing each length, in
the axis's heading, which turns where the point reflects at a face; a
point already visited is drawn again (up to 64 times: on the
configurations' grids every point is new). Every seed drags along the
same sweep, so its points meet the same regions of the data (the KSG
field's cost depends on them); only their spacing differs. The warm-up
drags from the mirrored start the other way.
"""

from __future__ import annotations

import numpy as np


def _walk(mix: dict, grid_xyz, gen: np.random.Generator, mirror: bool):
    lo, hi = int(mix["step_min"]), int(mix["step_max"])
    last = np.array(grid_xyz) - 1
    point = np.rint(np.array(mix["start"], float) * last).astype(np.int64)
    heading = np.ones(3, np.int64)
    if mirror:
        point, heading = last - point, -heading
    seen = {tuple(point)}
    yield tuple(int(c) for c in point)
    while True:
        for _ in range(64):
            cand = point + heading * gen.integers(lo, hi + 1, size=3)
            turn = (cand < 0) | (cand > last)
            cand = np.where(cand < 0, -cand, cand)
            cand = np.where(cand > last, 2 * last - cand, cand)
            if tuple(cand) not in seen:
                break
        point, heading = cand, np.where(turn, -heading, heading)
        seen.add(tuple(point))
        yield tuple(int(c) for c in point)


def window(mix: dict, grid_xyz, gen: np.random.Generator):
    return ({"point": p} for p in _walk(mix, grid_xyz, gen, False))


def warmup(mix: dict, grid_xyz, gen: np.random.Generator, count: int):
    walk = _walk(mix, grid_xyz, gen, True)
    return [{"point": next(walk)} for _ in range(count)]
