"""Radar bar chart — per-variable pie slices on a ring.

A copy of ``correrender_tpu/diagrams/radar.py``.
The reference's ``RadarBarChart`` (src/Renderers/Diagram/
RadarBarChart.{hpp,cpp}) draws one pie slice per variable around an
annulus:

* **time-independent** mode: the slice's outer radius encodes the
  variable's value (``value·(R−hole)+hole``,
  RadarBarChart.cpp:113-155), filled with a per-variable color
  (a 70 % blend of a palette color toward the palette color from
  white);
* **time-dependent** mode: each slice is split radially into one ring
  band per timestep, colored by a cool-to-warm transfer function of
  the value; the *equal-area* option sizes band radii so every band
  covers the same area (``r_out = √((R²−hole²)/T + r_in²)``,
  RadarBarChart.cpp:157-210) instead of equal radial steps.

Output is an SVG via :class:`~correrender_tpu_torch.diagrams.svg.SvgCanvas`
like every other diagram here.
"""

from __future__ import annotations

import math

import numpy as np

from correrender_tpu_torch.diagrams.colormaps import colormap_lut
from correrender_tpu_torch.diagrams.svg import SvgCanvas

#: Per-variable slice colors for the time-independent mode (a small
#: qualitative palette; the reference cycles its predefined sgl colors
#: the same way).
_SLICE_COLORS = [
    (0.122, 0.467, 0.706), (1.000, 0.498, 0.055),
    (0.173, 0.627, 0.173), (0.839, 0.153, 0.157),
    (0.580, 0.404, 0.741), (0.549, 0.337, 0.294),
    (0.890, 0.467, 0.761), (0.498, 0.498, 0.498),
    (0.737, 0.741, 0.133), (0.090, 0.745, 0.812),
]


def _slice_path(canvas, cx, cy, r_in, r_out, a0, a1, fill,
                stroke="black", stroke_width=0.75, tooltip=None):
    """Annular sector; a full 2π span (single-variable charts, like
    the reference's ``numVariables == 1`` circle special case) draws
    a complete ring."""
    if abs(a1 - a0) >= 2.0 * math.pi - 1e-6:
        canvas.annulus(cx, cy, r_in, r_out, fill=fill, stroke=stroke,
                       stroke_width=stroke_width, tooltip=tooltip)
    else:
        canvas.arc_ring(cx, cy, r_in, r_out, a0, a1, fill=fill,
                        stroke=stroke, stroke_width=stroke_width,
                        tooltip=tooltip)


class RadarBarChart:
    """SVG radar bar chart (reference RadarBarChart parity).

    Args:
      equal_area: time-dependent bands cover equal areas instead of
        equal radial extents (the reference's ``equalArea`` flag).
      hole_radius_frac: inner hole radius as a fraction of the chart
        radius (the reference's ``chartHoleRadius``).
      color_map: named colormap for time-dependent band values
        (default the reference's cool-to-warm points).
    """

    def __init__(self, equal_area: bool = True,
                 hole_radius_frac: float = 0.25,
                 color_map: str = "Cool to Warm"):
        self.equal_area = bool(equal_area)
        self.hole_radius_frac = float(hole_radius_frac)
        self.color_map = color_map
        self.variable_names: list[str] = []
        self._values = None          # (V,) time-independent
        self._values_t = None        # (T, V) time-dependent

    # -- data ------------------------------------------------------------

    def set_data_time_independent(self, variable_names, variable_values):
        """One value per variable (RadarBarChart::setDataTimeIndependent)."""
        self.variable_names = [str(n) for n in variable_names]
        v = np.asarray(variable_values, np.float32).reshape(-1)
        if v.shape[0] != len(self.variable_names):
            raise ValueError("one value per variable required")
        self._values, self._values_t = v, None

    def set_data_time_dependent(self, variable_names, variable_values):
        """``(T, V)`` values (RadarBarChart::setDataTimeDependent)."""
        self.variable_names = [str(n) for n in variable_names]
        v = np.atleast_2d(np.asarray(variable_values, np.float32))
        if v.shape[1] != len(self.variable_names):
            raise ValueError("values must be (timesteps, variables)")
        self._values_t, self._values = v, None

    # -- drawing ---------------------------------------------------------

    def _angle(self, var_frac: float) -> float:
        # Slices start at 12 o'clock and go clockwise, like the
        # reference's mapVarIdxToAngle. In time-dependent (time-step
        # color) mode the reference leaves a pi/32 gap at each end of
        # the ring (RadarBarChart.cpp:300-307), so the chart renders
        # as an open ring there.
        if self._values_t is not None:
            gap = math.pi / 32.0
            return -0.5 * math.pi + gap + (2.0 * math.pi - 2.0 * gap) * var_frac
        return -0.5 * math.pi + 2.0 * math.pi * var_frac

    def render_svg(self, path: str | None = None, size: int = 600) -> str:
        if self._values is None and self._values_t is None:
            raise ValueError("no data — call set_data_* first")
        canvas = SvgCanvas(size, size)
        cx = cy = size / 2.0
        radius = size * 0.36
        hole = radius * self.hole_radius_frac
        num_vars = len(self.variable_names)

        if self._values is not None:
            # The reference expects values pre-normalized to [0, 1]
            # (RadarBarChart.cpp:114-118); out-of-range data is scaled
            # down by its max rather than clipped.
            vmax = float(np.nanmax(self._values))
            norm = self._values / vmax if vmax > 1.0 else self._values
            for i, value in enumerate(norm):
                if not np.isfinite(value) or value <= 1e-7:
                    continue
                r = float(value) * (radius - hole) + hole
                base = np.asarray(
                    _SLICE_COLORS[i % len(_SLICE_COLORS)], np.float32)
                fill = tuple(0.3 + 0.7 * base)   # 70% toward the color
                a0 = self._angle(i / num_vars)
                a1 = self._angle((i + 1) / num_vars)
                _slice_path(
                    canvas, cx, cy, hole, r, a0, a1, fill,
                    tooltip=f"{self.variable_names[i]}: "
                            f"{float(self._values[i]):.4g}")
        else:
            lut = colormap_lut(self.color_map)
            vt = self._values_t
            lo = float(np.nanmin(vt))
            hi = float(np.nanmax(vt))
            span = (hi - lo) if hi > lo else 1.0
            num_t = vt.shape[0]
            for i in range(num_vars):
                a0 = self._angle(i / num_vars)
                a1 = self._angle((i + 1) / num_vars)
                r_in = hole
                for t in range(num_t):
                    if self.equal_area:
                        r_out = math.sqrt(
                            (radius * radius - hole * hole) / num_t
                            + r_in * r_in)
                    else:
                        r_out = hole + (radius - hole) * (t + 1) / num_t
                    value = float(vt[t, i])
                    u = (value - lo) / span if np.isfinite(value) else 0.0
                    color = tuple(
                        lut[int(np.clip(u, 0.0, 1.0) * (len(lut) - 1))])
                    _slice_path(
                        canvas, cx, cy, r_in, r_out, a0, a1, color,
                        stroke_width=0.4,
                        tooltip=f"{self.variable_names[i]} "
                                f"t={t}: {value:.4g}")
                    r_in = r_out

        # Variable labels around the outside.
        label_r = radius * 1.12
        for i, name in enumerate(self.variable_names):
            a = self._angle((i + 0.5) / num_vars)
            x = cx + math.cos(a) * label_r
            y = cy + math.sin(a) * label_r
            canvas.text(x, y, name, size=max(9, size // 50))

        svg = canvas.to_svg()
        if path:
            with open(path, "w") as f:
                f.write(svg)
        return svg
