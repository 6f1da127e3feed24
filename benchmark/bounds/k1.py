"""K1 (``csrc/pearson.cu``): ``v`` series of ``n`` float32 members
read once, the reference series read, the ``(v,)`` field written; 5
operations a member (the sums of y, y² and xy)."""

from benchmark.bounds import least_seconds


def least(shape: dict) -> tuple[float, str]:
    v, n = shape["v"], shape["n"]
    return least_seconds(4 * v * n + 4 * v + 4 * n, 5.0 * v * n)
