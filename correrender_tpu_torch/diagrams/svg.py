"""Dependency-free SVG canvas for diagram output.

A copy of ``correrender_tpu/diagrams/svg.py``. Replaces the reference's
NanoVG/Skia/VKVG vector backends (src/Renderers/Diagram/
DiagramBase.hpp:89-105): vector drawing runs on the host, and SVG is
portable and diffable in tests.
"""

from __future__ import annotations

import math


def _fmt_color(c) -> str:
    if isinstance(c, str):
        return c
    vals = [int(round(255 * float(v))) for v in c[:3]]
    return f"rgb({vals[0]},{vals[1]},{vals[2]})"


class SvgCanvas:
    def __init__(self, width: int = 800, height: int = 800,
                 background="white"):
        self.width = width
        self.height = height
        self._elems: list[str] = []
        if background:
            self._elems.append(
                f'<rect width="{width}" height="{height}" '
                f'fill="{_fmt_color(background)}"/>'
            )

    def line(self, x1, y1, x2, y2, color="black", width=1.0, opacity=1.0):
        self._elems.append(
            f'<line x1="{x1:.2f}" y1="{y1:.2f}" x2="{x2:.2f}" y2="{y2:.2f}" '
            f'stroke="{_fmt_color(color)}" stroke-width="{width}" '
            f'stroke-opacity="{opacity:.3f}"/>'
        )

    def circle(self, cx, cy, r, fill="black", stroke=None, opacity=1.0):
        stroke_attr = (
            f' stroke="{_fmt_color(stroke)}"' if stroke is not None else ""
        )
        self._elems.append(
            f'<circle cx="{cx:.2f}" cy="{cy:.2f}" r="{r:.2f}" '
            f'fill="{_fmt_color(fill)}" fill-opacity="{opacity:.3f}"'
            f"{stroke_attr}/>"
        )

    def rect(self, x, y, w, h, fill="black", opacity=1.0):
        self._elems.append(
            f'<rect x="{x:.2f}" y="{y:.2f}" width="{w:.2f}" '
            f'height="{h:.2f}" fill="{_fmt_color(fill)}" '
            f'fill-opacity="{opacity:.3f}"/>'
        )

    def path(self, points, color="black", width=1.0, opacity=1.0,
             closed=False, tooltip=None):
        """Polyline / bezier path from (x, y) points.

        ``tooltip`` emits an SVG ``<title>`` child — the hover tooltip
        role of the reference's diagram tooltips (HEBChartUi)."""
        d = f"M {points[0][0]:.2f} {points[0][1]:.2f} " + " ".join(
            f"L {x:.2f} {y:.2f}" for x, y in points[1:]
        )
        if closed:
            d += " Z"
        inner = ""
        if tooltip is not None:
            from xml.sax.saxutils import escape

            inner = f"<title>{escape(str(tooltip))}</title>"
        self._elems.append(
            f'<path d="{d}" fill="none" stroke="{_fmt_color(color)}" '
            f'stroke-width="{width}" stroke-opacity="{opacity:.3f}"'
            + (f">{inner}</path>" if inner else "/>")
        )

    def bezier(self, control_points, color="black", width=1.0, opacity=1.0):
        """Cubic beziers through successive control-point windows."""
        cp = control_points
        if len(cp) < 4 or (len(cp) - 1) % 3 != 0:
            raise ValueError(
                "cubic bezier needs 1 + 3k control points, got "
                f"{len(cp)}"
            )
        d = f"M {cp[0][0]:.2f} {cp[0][1]:.2f}"
        for i in range(1, len(cp) - 2, 3):
            d += (
                f" C {cp[i][0]:.2f} {cp[i][1]:.2f},"
                f" {cp[i+1][0]:.2f} {cp[i+1][1]:.2f},"
                f" {cp[i+2][0]:.2f} {cp[i+2][1]:.2f}"
            )
        self._elems.append(
            f'<path d="{d}" fill="none" stroke="{_fmt_color(color)}" '
            f'stroke-width="{width}" stroke-opacity="{opacity:.3f}"/>'
        )

    def text(self, x, y, content, size=12, color="black", anchor="middle",
             rotate=None):
        from xml.sax.saxutils import escape

        rot = (
            f' transform="rotate({rotate:.1f} {x:.2f} {y:.2f})"'
            if rotate is not None
            else ""
        )
        # escape: labels come straight from dataset field names — an
        # '&' or '<' written verbatim makes the SVG unparsable.
        self._elems.append(
            f'<text x="{x:.2f}" y="{y:.2f}" font-size="{size}" '
            f'fill="{_fmt_color(color)}" text-anchor="{anchor}"'
            f"{rot}>{escape(str(content))}</text>"
        )

    def arc_ring(self, cx, cy, r_inner, r_outer, a0, a1, fill="gray",
                 opacity=1.0, stroke=None, stroke_width=0.75,
                 tooltip=None):
        """Annular sector between angles a0..a1 (radians).

        ``r_inner=0`` degenerates to a plain pie slice (an SVG arc
        with radius 0 renders as a line per spec)."""
        def pt(r, a):
            return cx + r * math.cos(a), cy + r * math.sin(a)

        large = 1 if (a1 - a0) % (2 * math.pi) > math.pi else 0
        x0o, y0o = pt(r_outer, a0)
        x1o, y1o = pt(r_outer, a1)
        x1i, y1i = pt(r_inner, a1)
        x0i, y0i = pt(r_inner, a0)
        d = (
            f"M {x0o:.2f} {y0o:.2f} "
            f"A {r_outer:.2f} {r_outer:.2f} 0 {large} 1 {x1o:.2f} {y1o:.2f} "
            f"L {x1i:.2f} {y1i:.2f} "
            f"A {r_inner:.2f} {r_inner:.2f} 0 {large} 0 {x0i:.2f} {y0i:.2f} Z"
        )
        extra = ""
        if stroke is not None:
            extra = (f' stroke="{_fmt_color(stroke)}"'
                     f' stroke-width="{stroke_width}"')
        inner = ""
        if tooltip is not None:
            from xml.sax.saxutils import escape

            inner = f"<title>{escape(str(tooltip))}</title>"
        self._elems.append(
            f'<path d="{d}" fill="{_fmt_color(fill)}" '
            f'fill-opacity="{opacity:.3f}"{extra}'
            + (f">{inner}</path>" if inner else "/>")
        )

    def annulus(self, cx, cy, r_inner, r_outer, fill="gray",
                opacity=1.0, stroke=None, stroke_width=0.75,
                tooltip=None):
        """Full ring (or disc when ``r_inner=0``) — the 2π case an
        SVG arc cannot express (identical endpoints draw nothing)."""
        def circle(r, winding):
            # Two half arcs; winding 1 = clockwise outer, 0 = ccw hole.
            return (
                f"M {cx - r:.2f} {cy:.2f} "
                f"A {r:.2f} {r:.2f} 0 1 {winding} {cx + r:.2f} {cy:.2f} "
                f"A {r:.2f} {r:.2f} 0 1 {winding} {cx - r:.2f} {cy:.2f} Z"
            )

        d = circle(r_outer, 1)
        if r_inner > 1e-6:
            d += " " + circle(r_inner, 0)
        extra = ""
        if stroke is not None:
            extra = (f' stroke="{_fmt_color(stroke)}"'
                     f' stroke-width="{stroke_width}"')
        inner = ""
        if tooltip is not None:
            from xml.sax.saxutils import escape

            inner = f"<title>{escape(str(tooltip))}</title>"
        self._elems.append(
            f'<path d="{d}" fill="{_fmt_color(fill)}" '
            f'fill-rule="evenodd" fill-opacity="{opacity:.3f}"{extra}'
            + (f">{inner}</path>" if inner else "/>")
        )

    def to_svg(self) -> str:
        body = "\n".join(self._elems)
        return (
            f'<svg xmlns="http://www.w3.org/2000/svg" '
            f'width="{self.width}" height="{self.height}" '
            f'viewBox="0 0 {self.width} {self.height}">\n{body}\n</svg>\n'
        )

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_svg())
