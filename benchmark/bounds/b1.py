"""B1 (``csrc/moments.cu``), one accumulating launch on an ``(e, v)``
member chunk: the chunk and its ``e`` reference values read once, the
three float32 running sums read and written once; Σy, Σy² and Σxy take
5 operations a value (two multiply-adds and an add)."""

from benchmark.bounds import least_seconds


def least(shape: dict) -> tuple[float, str]:
    e, v = shape["e"], shape["v"]
    return least_seconds(shape["bytes_per_value"] * e * v + 4 * e
                         + 2 * 12 * v, 5.0 * e * v)
