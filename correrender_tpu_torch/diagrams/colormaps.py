"""Named diagram colormaps — the reference's ``DiagramColorMap`` set.

A copy of ``correrender_tpu/diagrams/colormaps.py`` (numpy only), so the
port imports nothing of the JAX package.

The reference ships 38 named colormaps for its diagram family
(DiagramColorMap.hpp:37-55: 10 sequential + 13 diverging matplotlib
maps, ParaView's cool-to-warm, and the neon / black-ramp selection
families used by the focus+context charts).  State files reference
them by display name (``color_map_<i>`` / ``color_map_variance``
DiagramRenderer settings, DiagramRenderer.cpp:1642-1670), so a
compatible set — same names, same color families — is part of the
state-interchange surface, not just styling.

The matplotlib-family tables below were sampled from matplotlib's own
colormap data (LUT indices 0/64/128/192/255, the same five-point
sampling the reference uses; six points for the magma-based heatmap),
i.e. they come from the public upstream source, not from the
reference's tables.  ``Cool to Warm`` is Moreland's published smooth
cool-warm table (the ParaView default).  The neon / black families
are generated by the same simple ramps the reference styles its
selection charts with (constant neon color; ``t * base`` for
``t ∈ [start, 1]``, DiagramColorMap.cpp:254-287).
"""

from __future__ import annotations

import numpy as np

# Display names, order-compatible with DIAGRAM_COLOR_MAP_NAMES
# (DiagramColorMap.hpp:46-54) so state files can also address maps by
# index if they ever need to.
COLOR_MAP_NAMES = (
    "Viridis", "Heatmap", "Cividis", "Gray",
    "Spring", "Summer", "Autumn", "Winter", "Cool", "Wistia",
    "Cool to Warm",
    "PiYG", "PRGn", "BrBG", "PuOr", "RdGy", "RdBu", "RdYlBu",
    "RdYlGn", "Spectral", "Coolwarm", "bwr", "Seismic",
    "Neon Greens", "Neon Green", "Neon Red", "Neon Blue", "Neon Orange",
    "Black-Yellow", "Black-Orange", "Black-Green", "Black-Blue",
    "Black-Cyan", "Black-Purple",
    "Black-Neon Green", "Black-Neon Red", "Black-Neon Blue",
    "Black-Neon Orange",
)

# matplotlib colormaps sampled at LUT indices (0, 64, 128, 192, 255).
_MPL = {
    "viridis": [(0.267, 0.0049, 0.3294), (0.2297, 0.3224, 0.5457),
                (0.1276, 0.5669, 0.5506), (0.3692, 0.7889, 0.3829),
                (0.9932, 0.9062, 0.1439)],
    "cividis": [(0.0, 0.1351, 0.3048), (0.2637, 0.3078, 0.4228),
                (0.4887, 0.4853, 0.471), (0.7365, 0.6806, 0.424),
                (0.9957, 0.9093, 0.2178)],
    "gray": [(0.0, 0.0, 0.0), (0.251, 0.251, 0.251),
             (0.502, 0.502, 0.502), (0.7529, 0.7529, 0.7529),
             (1.0, 1.0, 1.0)],
    "spring": [(1.0, 0.0, 1.0), (1.0, 0.251, 0.749),
               (1.0, 0.502, 0.498), (1.0, 0.7529, 0.2471),
               (1.0, 1.0, 0.0)],
    "summer": [(0.0, 0.5, 0.4), (0.251, 0.6255, 0.4),
               (0.502, 0.751, 0.4), (0.7529, 0.8765, 0.4),
               (1.0, 1.0, 0.4)],
    "autumn": [(1.0, 0.0, 0.0), (1.0, 0.251, 0.0),
               (1.0, 0.502, 0.0), (1.0, 0.7529, 0.0),
               (1.0, 1.0, 0.0)],
    "winter": [(0.0, 0.0, 1.0), (0.0, 0.251, 0.8745),
               (0.0, 0.502, 0.749), (0.0, 0.7529, 0.6235),
               (0.0, 1.0, 0.5)],
    "cool": [(0.0, 1.0, 1.0), (0.251, 0.749, 1.0),
             (0.502, 0.498, 1.0), (0.7529, 0.2471, 1.0),
             (1.0, 0.0, 1.0)],
    "wistia": [(0.8941, 1.0, 0.4784), (1.0, 0.9091, 0.1016),
               (1.0, 0.7403, 0.0), (0.9999, 0.6259, 0.0),
               (0.9882, 0.498, 0.0)],
    "piyg": [(0.5569, 0.0039, 0.3216), (0.9086, 0.5926, 0.7703),
             (0.9673, 0.9685, 0.9656), (0.6032, 0.8055, 0.3822),
             (0.1529, 0.3922, 0.098)],
    "prgn": [(0.251, 0.0, 0.2941), (0.682, 0.5452, 0.7426),
             (0.9663, 0.9681, 0.9659), (0.4932, 0.7654, 0.4967),
             (0.0, 0.2667, 0.1059)],
    "brbg": [(0.3294, 0.1882, 0.0196), (0.813, 0.6358, 0.3364),
             (0.9572, 0.9599, 0.9596), (0.3463, 0.6918, 0.6531),
             (0.0, 0.2353, 0.1882)],
    "puor": [(0.498, 0.2314, 0.0314), (0.9364, 0.6178, 0.2364),
             (0.9662, 0.9664, 0.9677), (0.5942, 0.5543, 0.7446),
             (0.1765, 0.0, 0.2941)],
    "rdgy": [(0.4039, 0.0, 0.1216), (0.8992, 0.5144, 0.4079),
             (0.9976, 0.9976, 0.9976), (0.6235, 0.6235, 0.6235),
             (0.102, 0.102, 0.102)],
    "rdbu": [(0.4039, 0.0, 0.1216), (0.8992, 0.5144, 0.4079),
             (0.9657, 0.9672, 0.9681), (0.4085, 0.6687, 0.8145),
             (0.0196, 0.1882, 0.3804)],
    "rdylbu": [(0.6471, 0.0, 0.149), (0.9749, 0.5574, 0.3227),
               (0.9976, 0.9991, 0.7534), (0.5564, 0.7596, 0.8639),
               (0.1922, 0.2118, 0.5843)],
    "rdylgn": [(0.6471, 0.0, 0.149), (0.9749, 0.5574, 0.3227),
               (0.9971, 0.9988, 0.745), (0.5181, 0.7928, 0.4012),
               (0.0, 0.4078, 0.2157)],
    "spectral": [(0.6196, 0.0039, 0.2588), (0.9749, 0.5574, 0.3227),
                 (0.9981, 0.9992, 0.746), (0.5273, 0.8106, 0.6452),
                 (0.3686, 0.3098, 0.6353)],
    "coolwarm": [(0.2298, 0.2987, 0.7537), (0.5543, 0.6901, 0.9955),
                 (0.8674, 0.8644, 0.8626), (0.9567, 0.598, 0.4773),
                 (0.7057, 0.0156, 0.1502)],
    "bwr": [(0.0, 0.0, 1.0), (0.502, 0.502, 1.0),
            (1.0, 0.9961, 0.9961), (1.0, 0.4941, 0.4941),
            (1.0, 0.0, 0.0)],
    "seismic": [(0.0, 0.0, 0.3), (0.0039, 0.0039, 1.0),
                (1.0, 0.9922, 0.9922), (0.9941, 0.0, 0.0),
                (0.5, 0.0, 0.0)],
    # matplotlib magma at six points, pinned to exact black at 0 — the
    # reference's "Heatmap".
    "heatmap": [(0.0, 0.0, 0.0), (0.2321, 0.0599, 0.4377),
                (0.5503, 0.1612, 0.5057), (0.8688, 0.2877, 0.4093),
                (0.9947, 0.6243, 0.4274), (0.9871, 0.9914, 0.7495)],
    # Moreland's smooth cool-warm (ParaView default), five-point table
    # from the published diverging-colormap paper.
    "cool to warm": [(0.2314, 0.298, 0.7529), (0.5647, 0.698, 0.9961),
                     (0.8627, 0.8627, 0.8627), (0.9608, 0.6118, 0.4902),
                     (0.7059, 0.0157, 0.149)],
}

# Neon selection colors (green, red, blue, orange) and the black-ramp
# base colors used by the reference's selection charts.
_NEON = {
    "green": (100 / 255, 1.0, 100 / 255),
    "red": (1.0, 60 / 255, 50 / 255),
    "blue": (0.0, 170 / 255, 1.0),
    "orange": (1.0, 148 / 255, 60 / 255),
}
_BLACK_BASE = {
    "yellow": (1.0, 1.0, 100 / 255),
    "orange": (252 / 255, 127 / 255, 0.0),
    "green": (0.0, 1.0, 127 / 255),
    "blue": (0.0, 127 / 255, 1.0),
    "cyan": (0.0, 1.0, 1.0),
    "purple": (1.0, 0.0, 1.0),
}


def _build_table():
    table = {}
    for key, pts in _MPL.items():
        table[key] = [tuple(p) for p in pts]
    # Light-to-neon green two-point ramp.
    table["neon greens"] = [(208 / 255, 231 / 255, 208 / 255),
                            _NEON["green"]]
    for color, rgb in _NEON.items():
        table[f"neon {color}"] = [rgb, rgb]
        t = [0.25 + 0.75 * i / 4.0 for i in range(5)]
        table[f"black-neon {color}"] = [
            tuple(ti * c for c in rgb) for ti in t]
    for color, rgb in _BLACK_BASE.items():
        t = [0.3 + 0.7 * i / 4.0 for i in range(5)]
        table[f"black-{color}"] = [
            tuple(ti * c for c in rgb) for ti in t]
    return table


_TABLE = _build_table()


def _norm(name: str) -> str:
    return str(name).strip().lower().replace("_", " ")


def is_known(name) -> bool:
    """True if ``name`` resolves to a diagram colormap (display name
    like ``"Cool to Warm"`` / ``"Black-Neon Green"``, any case, with
    ``_`` accepted for spaces)."""
    return _norm(name) in _TABLE


def get_color_points(name):
    """Evenly spaced RGB control points for a named colormap.

    Accepts the reference's display names (``DIAGRAM_COLOR_MAP_NAMES``)
    case-insensitively, with underscores accepted for spaces.  Returns
    ``[(r, g, b), ...]`` in [0, 1].
    """
    key = _norm(name)
    if key not in _TABLE:
        raise KeyError(
            f"unknown colormap {name!r}; known: "
            + ", ".join(sorted(_TABLE)))
    return [tuple(float(c) for c in p) for p in _TABLE[key]]


def colormap_lut(name, resolution: int = 256) -> np.ndarray:
    """``(resolution, 3)`` float32 RGB LUT, linear interpolation
    between the map's evenly spaced control points."""
    pts = np.asarray(get_color_points(name), np.float32)
    xs = np.linspace(0.0, 1.0, len(pts), dtype=np.float32)
    t = np.linspace(0.0, 1.0, resolution, dtype=np.float32)
    return np.stack(
        [np.interp(t, xs, pts[:, c]) for c in range(3)],
        axis=-1).astype(np.float32)


_DISPLAY = {_norm(n): n for n in COLOR_MAP_NAMES}


def display_name(name) -> str:
    """Canonical display name (``DIAGRAM_COLOR_MAP_NAMES`` spelling)
    for any accepted spelling; the input unchanged if unknown."""
    return _DISPLAY.get(_norm(name), str(name))


def all_names():
    """All display names, reference order."""
    return list(COLOR_MAP_NAMES)
