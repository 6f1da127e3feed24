"""How fast the host's CPU is in a run.

:func:`probe` is fixed work shaped like a host-paced frame's Python and
numpy: a walk of a point over a grid in plain Python, as the traffic's
next action is, then small numpy arrays as ``shearwarp_geometry`` builds
them for a 1080p frame. Its work never changes (a fixed seed, fixed
sizes), so its time reads the machine and not the program; it loads
neither torch nor the port. :func:`probe_ms` times it.
"""

from __future__ import annotations

import random
import statistics
import time

import numpy as np

#: The probe's fixed work: steps of the walk, frames of the geometry.
WALK_STEPS, GEOMETRY_FRAMES = 2_500, 40
#: The walk's grid and the geometry's frame (``linear_4x4`` at 1080p).
GRID, FRAME = (128, 128, 32), (1920, 1080)
_SEED = 20_240_611


def _walk(steps: int) -> int:
    """A seeded walk of one point in plain Python: each step moves every
    axis by 1-4 voxels in its heading, reflecting at the faces, and
    draws again where the point was visited. Returns the draws made."""
    gen = random.Random(_SEED)
    last = [s - 1 for s in GRID]
    point, heading = [s // 4 for s in last], [1, 1, 1]
    seen = {tuple(point)}
    draws = 0
    for _ in range(steps):
        for _ in range(64):
            draws += 1
            cand, turn = [], []
            for p, h, hi in zip(point, heading, last):
                c = p + h * gen.randint(1, 4)
                turn.append(c < 0 or c > hi)
                cand.append(-c if c < 0 else 2 * hi - c if c > hi else c)
            if tuple(cand) not in seen:
                break
        point = cand
        heading = [-h if t else h for h, t in zip(heading, turn)]
        seen.add(tuple(point))
    return draws


def _geometry(frames: int) -> int:
    """``frames`` times the shear-warp set-up's host arrays: voxel
    centres along three axes, slice factors, the footprint's bounds and
    the two float32 grids of the intermediate image. Returns the frames
    made."""
    width, height = FRAME
    for f in range(frames):
        eye = np.array([0.05, 0.3, 0.85 + 1e-4 * f], np.float32)
        centres = [-0.5 + (np.arange(n) + 0.5) / n for n in GRID]
        z = centres[2][::-1]
        g = (z - eye[2]) / (z[0] - eye[2])
        lo_u = hi_u = lo_v = hi_v = 0.0
        for gk in (g.min(), g.max(), 1.0):
            cu = eye[0] + (np.array([centres[0][0], centres[0][-1]])
                           - eye[0]) / gk
            cv = eye[1] + (np.array([centres[1][0], centres[1][-1]])
                           - eye[1]) / gk
            lo_u, hi_u = min(lo_u, cu.min()), max(hi_u, cu.max())
            lo_v, hi_v = min(lo_v, cv.min()), max(hi_v, cv.max())
        grid_u = np.linspace(lo_u, hi_u, width).astype(np.float32)
        grid_v = np.linspace(lo_v, hi_v, height).astype(np.float32)
        np.sqrt(grid_u[None, :64] ** 2 + grid_v[:64, None] ** 2 + 1.0)
    return frames


def probe() -> int:
    """Run the fixed work once; returns its count of operations (the
    walk's draws and the geometry's frames), the same on every call."""
    return _walk(WALK_STEPS) + _geometry(GEOMETRY_FRAMES)


def probe_ms(repeats: int) -> list[float]:
    """Milliseconds of ``repeats`` calls of :func:`probe`, one by one."""
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        probe()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def median(values) -> float | None:
    return statistics.median(values) if values else None
