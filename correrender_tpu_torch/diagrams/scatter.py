"""Scatter-plot diagram of two scalar fields.

A copy of ``correrender_tpu/diagrams/scatter.py``.
Reference: src/Renderers/Diagram/Scatter/* — per-voxel (field A,
field B) value pairs as a 2D scatter/density chart.
"""

from __future__ import annotations

import re

import numpy as np

from correrender_tpu_torch.diagrams.svg import SvgCanvas


def scatter_points(field_a: np.ndarray, field_b: np.ndarray,
                   max_points: int = 4096, seed: int = 0,
                   colors=None):
    """Finite (a, b) value pairs, subsampled for plotting; an optional
    per-point ``colors`` array is filtered/subsampled in lockstep.
    The ONE filter/subsample definition (render_scatter_svg had an
    inline near-copy; round-3 review)."""
    a = np.asarray(field_a).ravel()
    b = np.asarray(field_b).ravel()
    colors = None if colors is None else np.asarray(colors).ravel()
    ok = np.isfinite(a) & np.isfinite(b)
    a, b = a[ok], b[ok]
    if colors is not None:
        colors = colors[ok]
    if len(a) > max_points:
        idx = np.random.default_rng(seed).choice(
            len(a), max_points, replace=False
        )
        a, b = a[idx], b[idx]
        if colors is not None:
            colors = colors[idx]
    return a, b, colors


def _parse_color(value):
    """RGB(A) tuple/list, or a serialized vector string (an imported
    reference state's ``point_color`` arrives as sgl's vec4 text,
    e.g. ``"0.9 0.3 0.1 1"`` / ``"vec4(0.9, 0.3, 0.1, 1)"``)."""
    if isinstance(value, str):
        s = value
        if "(" in s:  # "vec4(r, g, b, a)" — drop the constructor name
            s = s[s.index("(") + 1:]
        value = [float(p) for p in re.findall(
            r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", s)]
    comps = [float(v) for v in value][:3]
    if len(comps) < 3:
        raise ValueError(f"need at least 3 color components: {value!r}")
    if max(comps) > 1.0:            # 0-255 byte colors
        comps = [c / 255.0 for c in comps]
    return tuple(comps)


def render_scatter_svg(
    field_a,
    field_b,
    labels=("field A", "field B"),
    path=None,
    size: int = 600,
    colors=None,
    point_radius: float = 2.0,
    max_points: int = 4096,
    seed: int = 0,
    point_color=None,
) -> str:
    """Scatter-plot SVG; ``colors`` is an optional per-point cluster id
    array (colored via a categorical wheel, −1 = gray noise).
    ``point_color`` is an RGB(A) tuple overriding the default point
    fill when no cluster coloring is active (the reference's
    ``point_color`` ScatterPlotRenderer setting,
    ScatterPlotRenderer.cpp:510,539).

    Inputs are finite-filtered and subsampled to ``max_points`` HERE
    (with ``colors`` kept aligned) — plotting raw 3-D fields emitted
    one circle per voxel (a multi-GB SVG on a 256³ volume) and NaN
    voxels produced invalid cx="nan" coordinates (round-3 review).
    """
    a, b, colors = scatter_points(field_a, field_b,
                                  max_points=max_points, seed=seed,
                                  colors=colors)
    margin = 50
    span = size - 2 * margin
    canvas = SvgCanvas(size, size)
    if len(a) == 0:
        # Fully-masked input (all-NaN fields): an empty labeled plot
        # beats the zero-size nanmin ValueError this raised (round-3
        # review).
        canvas.text(size / 2, size / 2,
                    "no finite (A, B) value pairs", size=14)
        canvas.text(size / 2, size - margin / 3, labels[0], size=13)
        canvas.text(margin / 3, size / 2, labels[1], size=13,
                    rotate=-90)
        if path:
            canvas.save(path)
        return canvas.to_svg()

    def norm(v):
        lo, hi = np.nanmin(v), np.nanmax(v)
        return (v - lo) / (hi - lo + 1e-30)

    xs = margin + norm(a) * span
    ys = size - margin - norm(b) * span
    wheel = np.array(
        [
            (0.85, 0.37, 0.01), (0.11, 0.62, 0.47), (0.46, 0.44, 0.70),
            (0.91, 0.16, 0.54), (0.40, 0.65, 0.12), (0.90, 0.67, 0.01),
            (0.65, 0.46, 0.11), (0.4, 0.4, 0.4),
        ]
    )
    base_fill = (_parse_color(point_color)
                 if point_color is not None else (0.2, 0.4, 0.8))
    for i in range(len(xs)):
        if colors is not None:
            c = int(colors[i])
            fill = (0.6, 0.6, 0.6) if c < 0 else tuple(wheel[c % len(wheel)])
        else:
            fill = base_fill
        canvas.circle(xs[i], ys[i], point_radius, fill=fill, opacity=0.7)
    # Axes.
    canvas.line(margin, size - margin, size - margin, size - margin,
                color=(0, 0, 0))
    canvas.line(margin, size - margin, margin, margin, color=(0, 0, 0))
    canvas.text(size / 2, size - margin / 3, labels[0], size=13)
    canvas.text(margin / 3, size / 2, labels[1], size=13, rotate=-90)
    if path:
        canvas.save(path)
    return canvas.to_svg()
