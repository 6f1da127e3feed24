"""K3 (``csrc/shearwarp.cu``, the tap pre-pass and the composite): every
slice's bfloat16 RGBA layout (``s × yv × xv × 4`` values) read once and
the intermediate image's float32 rgb and alpha (and its path-length
factor) moved once, 20 bytes a pixel; a bilinear RGBA tap, the opacity
correction and OVER, about 36 operations per (intermediate pixel,
slice)."""

from benchmark.bounds import least_seconds


def least(shape: dict) -> tuple[float, str]:
    s, hi, wi = shape["s"], shape["hi"], shape["wi"]
    layout = s * shape["yv"] * shape["xv"] * 4
    return least_seconds(2 * layout + 20 * hi * wi, 36.0 * s * hi * wi)
