"""B10 (``csrc/ksg_banded.cu``), the least work of the KSG field
whatever the algorithm: ``v`` series of ``n`` members read once and the
field written; per voxel a comparison sort of y (n·log2 n
compare-exchanges of 2 operations); per point the k+1 nearest Chebyshev
distances (4 operations each) and its two marginal counts by binary
search (2·log2 n operations each)."""

import math

from benchmark.bounds import least_seconds


def least(shape: dict) -> tuple[float, str]:
    v, n, k = shape["v"], shape["n"], shape["k"]
    log2n = math.log2(n)
    io_bytes = 4 * v * n + 4 * n + 4 * v
    ops = 2.0 * v * n * log2n + v * n * (4.0 * (k + 1) + 4.0 * log2n)
    return least_seconds(io_bytes, ops)
