"""A camera flight around the volume: ``app/perf.py``'s orbit.

The camera steps along a circle around ``center`` at elevation ``phi``
and ``radius``, by ``2π / steps_per_turn`` a frame from the angle
``start``, looking at ``look_at``; the seed chooses the way it turns.
The box is symmetric under that mirror, so every seed's window meets
cameras of the same costs (a frame costs what its principal axis and
view make it). Each further turn is shifted by a fraction of a step
(the golden ratio's, turn by turn), so no camera is met twice in a
window. The warm-up visits ``count`` cameras spread over one turn,
each half a step off the window's, so it meets every principal axis and
slice order and no camera of the window.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.traffic import camera

_GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def _camera(mix: dict, theta: float) -> dict:
    phi, radius = float(mix["phi"]), float(mix["radius"])
    cx, cy, cz = (float(c) for c in mix.get("center", (0.0, 0.0, 0.0)))
    return camera(mix, position=(
        cx + radius * math.cos(phi) * math.sin(theta),
        cy + radius * math.sin(phi),
        cz + radius * math.cos(phi) * math.cos(theta)))


def window(mix: dict, grid_xyz, gen: np.random.Generator):
    turn = int(mix["steps_per_turn"])
    step = 2.0 * math.pi / turn * gen.choice([-1, 1])
    start = float(mix.get("start", 0.0))
    i = 0
    while True:
        shift = ((i // turn) * _GOLDEN) % 1.0
        yield {"camera": _camera(mix, start + (i + shift) * step)}
        i += 1


def warmup(mix: dict, grid_xyz, gen: np.random.Generator, count: int):
    start = float(mix.get("start", 0.0))
    half_step = math.pi / int(mix["steps_per_turn"])
    return [{"camera": _camera(mix, start + half_step + 2.0 * math.pi
                               * (j + 0.5) / count)} for j in range(count)]
