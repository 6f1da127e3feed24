"""The one traffic generator: a mix file's parameters and the seed in,
the interactions of one closed-loop user out.

A mix (``traffic/<name>.json``) names what each interaction moves in
``interaction``; the kind's file ``interactions/<kind>.py`` turns the
mix's parameters and the seed's generator into the interactions. The
seed chooses only spacings and ways, never the number or kind of the
interactions. Every mix is a closed loop with one client (``loop``,
``clients``): the next interaction is sent once the last result is
ready, or with a cell's ``ahead_s`` while the card is fed (``run.py``).
A mix that asks for another loop is refused.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import spec

#: Streams of one seed: the window's interactions, the warm-up's and the
#: check's sample.
STREAM_WINDOW, STREAM_WARMUP, STREAM_CHECK = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 63) - 1), stream])


def camera(spec: dict, position=None) -> dict:
    """A camera dict (``position``, ``look_at``, ``up``, ``fovy``,
    ``z_near``, ``z_far``) from a mix's camera settings."""
    return {
        "position": tuple(float(v) for v in (position or spec["position"])),
        "look_at": tuple(float(v) for v in spec.get("look_at", (0, 0, 0))),
        "up": tuple(float(v) for v in spec.get("up", (0, 1, 0))),
        "fovy": float(spec.get("fovy", math.pi / 4.0)),
        "z_near": float(spec.get("z_near", 0.001)),
        "z_far": float(spec.get("z_far", 100.0)),
    }


def kind(mix: dict):
    """The mix's interaction module, once its loop is checked."""
    loop, clients = mix.get("loop", "closed"), mix.get("clients", 1)
    if loop != "closed" or clients != 1:
        raise ValueError(f"the benchmark serves one closed-loop client, "
                         f"not loop {loop!r} with {clients!r} clients")
    return spec.load_module("interactions", mix["interaction"])


def interactions(mix: dict, grid_xyz, seed: int):
    """The window's endless interactions."""
    return kind(mix).window(mix, grid_xyz, rng(seed, STREAM_WINDOW))


def warmup(mix: dict, grid_xyz, seed: int, count: int) -> list:
    """``count`` interactions of the shapes the window meets, drawn apart
    from the window's, to run in set-up."""
    return kind(mix).warmup(mix, grid_xyz, rng(seed, STREAM_WARMUP), count)


def seeded_point(grid_xyz, seed: int) -> tuple:
    """One voxel drawn from the seed (a fixed reference point)."""
    gen = rng(seed, STREAM_WARMUP)
    return tuple(int(gen.integers(0, s)) for s in grid_xyz)


def check_sample(seed: int, count: int, within: int) -> list[int]:
    """The window's interactions whose outputs are kept for the check:
    ``count`` indices below ``within``, drawn from the seed."""
    gen = rng(seed, STREAM_CHECK)
    return sorted(int(i) for i in gen.choice(within, size=count,
                                             replace=False))
