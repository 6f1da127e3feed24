"""A drag of the reference point across the grid.

From ``start`` (fractions of the grid) each step moves every axis by
``step_min`` to ``step_max`` voxels in the axis's heading, which turns
where the point reflects at a face. The lengths come in blocks of
``BLOCK`` steps drawn once for every seed; the seed draws only the order
of the steps within each block. So every seed's drag meets every
block's end at the same point, and its points meet the same regions of
the data (the KSG field's cost depends on them): the work does not
depend on the seed. A step that would reach a point already visited
gives way to the block's next step that does not; where none is left,
the next block's steps join the rest, and the drag meets the block ends
again once they are all taken (on the configurations' grids every point
is new). The warm-up drags from the mirrored start the other way, with
lengths of its own.
"""

from __future__ import annotations

import numpy as np

#: Steps a block; every seed takes each block's steps, in its own order.
BLOCK = 16
#: The one draw of the step lengths, shared by every seed.
LENGTHS_SEED = 20_240_611


def _move(point, heading, step, last):
    cand = point + heading * step
    turn = (cand < 0) | (cand > last)
    cand = np.where(cand < 0, -cand, cand)
    cand = np.where(cand > last, 2 * last - cand, cand)
    return cand, np.where(turn, -heading, heading)


def _walk(mix: dict, grid_xyz, gen: np.random.Generator, mirror: bool):
    lo, hi = int(mix["step_min"]), int(mix["step_max"])
    lengths = np.random.default_rng([LENGTHS_SEED, int(mirror)])
    last = np.array(grid_xyz) - 1
    point = np.rint(np.array(mix["start"], float) * last).astype(np.int64)
    heading = np.ones(3, np.int64)
    if mirror:
        point, heading = last - point, -heading
    seen = {tuple(point)}
    yield tuple(int(c) for c in point)
    steps = []
    while True:
        if not steps:
            steps = _block(lengths, lo, hi, gen)
        moves = (_move(point, heading, s, last) for s in steps)
        pick = next((i for i, (cand, _) in enumerate(moves)
                     if tuple(cand) not in seen), None)
        if pick is None and len(steps) < 4 * BLOCK:
            steps += _block(lengths, lo, hi, gen)
            continue
        point, heading = _move(point, heading, steps.pop(pick or 0), last)
        seen.add(tuple(point))
        yield tuple(int(c) for c in point)


def _block(lengths, lo: int, hi: int, gen) -> list:
    """The next block's steps (the same for every seed), in the seed's
    order."""
    block = lengths.integers(lo, hi + 1, size=(BLOCK, 3))
    return list(block[gen.permutation(BLOCK)])


def window(mix: dict, grid_xyz, gen: np.random.Generator):
    return ({"point": p} for p in _walk(mix, grid_xyz, gen, False))


def warmup(mix: dict, grid_xyz, gen: np.random.Generator, count: int):
    walk = _walk(mix, grid_xyz, gen, True)
    return [{"point": next(walk)} for _ in range(count)]
