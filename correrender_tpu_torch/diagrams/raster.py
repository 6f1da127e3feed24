"""Rasterizer for the diagram SVG subset — the NanoVG role.

A copy of ``correrender_tpu/diagrams/raster.py``, except
:func:`composite_overlay`, which lays the overlay into a frame tensor
on the frame's device (the Scene's frames stay there).
The reference's diagram subsystem is an overlay renderer: charts draw
INTO the 3D view via NanoVG/Skia and appear in screenshots and videos
(src/Renderers/Diagram/DiagramRenderer.hpp:62-100). Here diagrams are
generated as SVG (diagrams/svg.py); this module rasterizes that SVG
subset to an RGBA array so `Scene.render_view` can composite charts
over rendered frames (and flythrough videos) the same way.

Scope: exactly the elements `SvgCanvas` emits — ``rect``, ``line``,
``circle``, ``path`` (M/L/C/A/Z, absolute), ``text`` — with the
attributes it writes. Parsing our own generated output keeps the
parser small and total; this is NOT a general SVG engine.

Implementation: supersampled scanline polygon fill (even-odd), pure
numpy. Strokes become quad-strip polygons with round joins. Text uses
matplotlib's TextPath outlines when matplotlib is importable (it is in
the supported environments) and degrades to skipping labels otherwise.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET

import numpy as np
import torch

_NS = "{http://www.w3.org/2000/svg}"


# -- color / attribute parsing ---------------------------------------------

_NAMED = {
    "black": (0.0, 0.0, 0.0), "white": (1.0, 1.0, 1.0),
    "gray": (0.5, 0.5, 0.5), "grey": (0.5, 0.5, 0.5),
    "red": (1.0, 0.0, 0.0), "green": (0.0, 0.5, 0.0),
    "blue": (0.0, 0.0, 1.0), "yellow": (1.0, 1.0, 0.0),
    "orange": (1.0, 0.65, 0.0), "purple": (0.5, 0.0, 0.5),
    "none": None,
}


def _parse_color(s):
    """``rgb(r,g,b)`` / ``#rrggbb`` / named → (r, g, b) in [0,1]."""
    if s is None:
        return None
    s = s.strip()
    if s.startswith("rgb"):
        vals = [float(v) for v in re.findall(r"[\d.]+", s)]
        return tuple(v / 255.0 for v in vals[:3])
    if s.startswith("#"):
        h = s[1:]
        if len(h) == 3:
            h = "".join(c * 2 for c in h)
        return tuple(int(h[i:i + 2], 16) / 255.0 for i in (0, 2, 4))
    return _NAMED.get(s.lower(), (0.0, 0.0, 0.0))


def _f(elem, attr, default=0.0):
    v = elem.get(attr)
    return float(v) if v is not None else float(default)


# -- path-data flattening ---------------------------------------------------

def _arc_points(x0, y0, rx, ry, large, sweep, x1, y1, n=24):
    """Flatten an SVG endpoint arc (rotation 0 — all we emit)."""
    if rx <= 0 or ry <= 0:
        return [(x1, y1)]
    # Endpoint → center parameterization (SVG spec B.2.4, rot=0).
    dx, dy = (x0 - x1) / 2.0, (y0 - y1) / 2.0
    lam = (dx / rx) ** 2 + (dy / ry) ** 2
    if lam > 1.0:
        s = math.sqrt(lam)
        rx, ry = rx * s, ry * s
    num = rx * rx * ry * ry - rx * rx * dy * dy - ry * ry * dx * dx
    den = rx * rx * dy * dy + ry * ry * dx * dx
    c = math.sqrt(max(num / den, 0.0)) if den > 0 else 0.0
    if large == sweep:
        c = -c
    cxp, cyp = c * rx * dy / ry, -c * ry * dx / rx
    cx, cy = cxp + (x0 + x1) / 2.0, cyp + (y0 + y1) / 2.0

    def angle(ux, uy, vx, vy):
        dot = ux * vx + uy * vy
        n_ = math.hypot(ux, uy) * math.hypot(vx, vy)
        a = math.acos(max(-1.0, min(1.0, dot / n_))) if n_ else 0.0
        return -a if ux * vy - uy * vx < 0 else a

    a0 = angle(1.0, 0.0, (x0 - cx) / rx, (y0 - cy) / ry)
    da = angle((x0 - cx) / rx, (y0 - cy) / ry,
               (x1 - cx) / rx, (y1 - cy) / ry)
    if not sweep and da > 0:
        da -= 2 * math.pi
    elif sweep and da < 0:
        da += 2 * math.pi
    pts = []
    for i in range(1, n + 1):
        a = a0 + da * i / n
        pts.append((cx + rx * math.cos(a), cy + ry * math.sin(a)))
    return pts


_PATH_TOKEN = re.compile(r"([MLCAZmlcaz])|(-?\d*\.?\d+(?:e-?\d+)?)")


def _flatten_path(d: str):
    """SVG path data → list of subpaths ([(x, y), …], closed_flag)."""
    tokens = []
    for cmd, num in _PATH_TOKEN.findall(d):
        tokens.append(cmd if cmd else float(num))
    subpaths, cur, closed = [], [], False
    i = 0
    cmd = None
    while i < len(tokens):
        t = tokens[i]
        if isinstance(t, str):
            cmd = t.upper()
            i += 1
            if cmd == "Z":
                if cur:
                    subpaths.append((cur, True))
                    cur = []
                cmd = None
            continue
        if cmd == "M":
            if cur:
                subpaths.append((cur, False))
            cur = [(tokens[i], tokens[i + 1])]
            i += 2
            cmd = "L"  # subsequent pairs are implicit linetos
        elif cmd == "L":
            cur.append((tokens[i], tokens[i + 1]))
            i += 2
        elif cmd == "C":
            (x0, y0) = cur[-1]
            c1 = (tokens[i], tokens[i + 1])
            c2 = (tokens[i + 2], tokens[i + 3])
            p1 = (tokens[i + 4], tokens[i + 5])
            i += 6
            for k in range(1, 17):
                t_ = k / 16.0
                mt = 1 - t_
                x = (mt ** 3 * x0 + 3 * mt * mt * t_ * c1[0]
                     + 3 * mt * t_ * t_ * c2[0] + t_ ** 3 * p1[0])
                y = (mt ** 3 * y0 + 3 * mt * mt * t_ * c1[1]
                     + 3 * mt * t_ * t_ * c2[1] + t_ ** 3 * p1[1])
                cur.append((x, y))
        elif cmd == "A":
            (x0, y0) = cur[-1]
            rx, ry, _rot, large, sweep, x1, y1 = tokens[i:i + 7]
            i += 7
            cur.extend(_arc_points(x0, y0, rx, ry, int(large),
                                   int(sweep), x1, y1))
        else:
            raise ValueError(f"unsupported path command {cmd!r}")
    if cur:
        subpaths.append((cur, False))
    return subpaths


# -- scanline fill ----------------------------------------------------------

def _coverage_even_odd(subpaths, h, w, union=False):
    """Scanline coverage of closed subpaths → (y0, x0, mask) or None.

    ``union=False``: even-odd parity across ALL subpaths together (SVG
    fill-rule, so annulus holes stay holes). ``union=True``: each
    subpath filled independently and OR-ed — the stroke case, where
    segment quads and round joins overlap and parity would wrongly
    cancel. The mask is bbox-limited (uint8 0/1).
    """
    groups = ([[sp] for sp in subpaths] if union else [subpaths]) \
        if subpaths else []
    edge_groups = []
    gx0 = gy0 = np.inf
    gx1 = gy1 = -np.inf
    for group in groups:
        edges = []
        for pts, _closed in group:
            arr = np.asarray(pts, np.float64)
            if len(arr) < 3:
                continue
            nxt = np.roll(arr, -1, axis=0)
            edges.append(np.concatenate([arr, nxt], axis=1))
        if not edges:
            continue
        e = np.concatenate(edges, axis=0)  # (E, 4): x0 y0 x1 y1
        keep = e[:, 1] != e[:, 3]
        e = e[keep]
        if e.shape[0] == 0:
            continue
        edge_groups.append(e)
        gx0 = min(gx0, e[:, (0, 2)].min())
        gx1 = max(gx1, e[:, (0, 2)].max())
        gy0 = min(gy0, e[:, (1, 3)].min())
        gy1 = max(gy1, e[:, (1, 3)].max())
    if not edge_groups:
        return None
    ymin = max(0, int(math.floor(gy0)))
    ymax = min(h - 1, int(math.ceil(gy1)))
    xmin = max(0, int(math.floor(gx0)))
    xmax = min(w - 1, int(math.ceil(gx1)))
    if ymax < ymin or xmax < xmin:
        return None
    mask = np.zeros((ymax - ymin + 1, xmax - xmin + 1), np.uint8)
    for e in edge_groups:
        x0, y0, x1, y1 = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
        lo, hi = np.minimum(y0, y1), np.maximum(y0, y1)
        slope = (x1 - x0) / (y1 - y0)
        ey0 = max(ymin, int(math.floor(lo.min())))
        ey1 = min(ymax, int(math.ceil(hi.max())))
        for y in range(ey0, ey1 + 1):
            yc = y + 0.5
            m = (lo <= yc) & (yc < hi)
            if not m.any():
                continue
            xs = np.sort(x0[m] + (yc - y0[m]) * slope[m])
            for k in range(0, xs.size - 1, 2):
                xa = max(xmin, int(math.ceil(xs[k] - 0.5)))
                xb = min(xmax + 1, int(math.ceil(xs[k + 1] - 0.5)))
                if xb > xa:
                    mask[y - ymin, xa - xmin:xb - xmin] = 1
    return ymin, xmin, mask


def _fill_even_odd(buf, subpaths, rgba, union=False):
    """Source-over blend of a coverage-filled primitive into ``buf``
    ((H, W, 4) float32 straight alpha). One blend per primitive, so
    semi-transparent strokes don't double-darken at joins."""
    src_a = float(rgba[3])
    if src_a <= 0.0:
        return
    cov = _coverage_even_odd(subpaths, *buf.shape[:2], union=union)
    if cov is None:
        return
    y0, x0, mask = cov
    region = buf[y0:y0 + mask.shape[0], x0:x0 + mask.shape[1]]
    a = mask[:, :, None].astype(np.float32) * src_a
    src_rgb = np.asarray(rgba[:3], np.float32)
    da = region[:, :, 3:4]
    out_a = a + da * (1.0 - a)
    region[:, :, :3] = np.where(
        out_a > 1e-12,
        (src_rgb * a + region[:, :, :3] * da * (1.0 - a))
        / np.maximum(out_a, 1e-12),
        region[:, :, :3])
    region[:, :, 3:4] = out_a


def _stroke_to_polys(pts, width, closed=False):
    """Polyline → fill polygons (segment quads + round joins)."""
    r = max(width, 0.1) / 2.0
    polys = []
    pts = [tuple(p) for p in pts]
    if closed and len(pts) > 2 and pts[0] != pts[-1]:
        pts = pts + [pts[0]]
    for (xa, ya), (xb, yb) in zip(pts[:-1], pts[1:]):
        dx, dy = xb - xa, yb - ya
        n = math.hypot(dx, dy)
        if n < 1e-9:
            continue
        ox, oy = -dy / n * r, dx / n * r
        polys.append(([(xa + ox, ya + oy), (xb + ox, yb + oy),
                       (xb - ox, yb - oy), (xa - ox, ya - oy)], True))
    if len(pts) > 2 or closed:
        circle = [(math.cos(a), math.sin(a))
                  for a in np.linspace(0, 2 * math.pi, 9)[:-1]]
        join_pts = pts[1:-1] if not closed else pts[:-1]
        for (jx, jy) in join_pts:
            polys.append(
                ([(jx + r * c, jy + r * s) for c, s in circle], True))
    return polys


def _circle_poly(cx, cy, r, n=48):
    ang = np.linspace(0.0, 2 * math.pi, n, endpoint=False)
    return [(cx + r * math.cos(a), cy + r * math.sin(a)) for a in ang]


# -- text -------------------------------------------------------------------

def _text_polys(content, x, y, size, anchor, rotate):
    """Glyph outline polygons via matplotlib's TextPath (lazy import;
    returns [] when matplotlib is unavailable — labels drop, charts
    still render)."""
    try:
        from matplotlib.font_manager import FontProperties
        from matplotlib.textpath import TextPath
    except Exception:  # pragma: no cover - matplotlib is baked in
        return []
    tp = TextPath((0, 0), str(content), size=size,
                  prop=FontProperties(family="DejaVu Sans"))
    polys = tp.to_polygons()
    if not polys:
        return []
    xs = np.concatenate([p[:, 0] for p in polys])
    width = float(xs.max() - xs.min()) if xs.size else 0.0
    dx = {"middle": -width / 2.0, "end": -width}.get(anchor, 0.0)
    cr, sr = 1.0, 0.0
    if rotate:
        a = math.radians(rotate)
        cr, sr = math.cos(a), math.sin(a)
    out = []
    for p in polys:
        # TextPath y is up; SVG y is down → flip, then place/rotate.
        px, py = p[:, 0] + dx, -p[:, 1]
        rx = x + px * cr - py * sr
        ry = y + px * sr + py * cr
        out.append((list(zip(rx.tolist(), ry.tolist())), True))
    return out


# -- main entry -------------------------------------------------------------

def rasterize_svg(svg: str, scale: float = 1.0,
                  supersample: int = 2) -> np.ndarray:
    """Rasterize a diagrams/svg.py-generated SVG string.

    Returns (H, W, 4) float32, straight alpha, H/W = svg size × scale.
    """
    root = ET.fromstring(svg)
    width = int(round(float(root.get("width", 800)) * scale))
    height = int(round(float(root.get("height", 800)) * scale))
    ss = max(1, int(supersample))
    s = scale * ss
    buf = np.zeros((height * ss, width * ss, 4), np.float32)

    for elem in root:
        tag = elem.tag.replace(_NS, "")
        if tag == "rect":
            fill = _parse_color(elem.get("fill", "black"))
            if fill is None:
                continue
            a = _f(elem, "fill-opacity", 1.0)
            x, y = _f(elem, "x") * s, _f(elem, "y") * s
            w_, h_ = _f(elem, "width") * s, _f(elem, "height") * s
            _fill_even_odd(
                buf, [([(x, y), (x + w_, y), (x + w_, y + h_),
                        (x, y + h_)], True)], (*fill, a))
        elif tag == "line":
            stroke = _parse_color(elem.get("stroke", "black"))
            if stroke is None:
                continue
            a = _f(elem, "stroke-opacity", 1.0)
            w_ = _f(elem, "stroke-width", 1.0) * s
            pts = [(_f(elem, "x1") * s, _f(elem, "y1") * s),
                   (_f(elem, "x2") * s, _f(elem, "y2") * s)]
            _fill_even_odd(buf, _stroke_to_polys(pts, w_), (*stroke, a),
                           union=True)
        elif tag == "circle":
            cx, cy = _f(elem, "cx") * s, _f(elem, "cy") * s
            r = _f(elem, "r") * s
            fill = _parse_color(elem.get("fill", "black"))
            if fill is not None:
                a = _f(elem, "fill-opacity", 1.0)
                _fill_even_odd(buf, [(_circle_poly(cx, cy, r), True)],
                               (*fill, a))
            stroke = _parse_color(elem.get("stroke"))
            if stroke is not None:
                w_ = _f(elem, "stroke-width", 1.0) * s
                _fill_even_odd(
                    buf,
                    _stroke_to_polys(_circle_poly(cx, cy, r), w_,
                                     closed=True),
                    (*stroke, 1.0), union=True)
        elif tag == "path":
            subpaths = _flatten_path(elem.get("d", ""))
            subpaths = [([(px * s, py * s) for px, py in pts], cl)
                        for pts, cl in subpaths]
            fill = _parse_color(elem.get("fill", "black"))
            if fill is not None:
                a = _f(elem, "fill-opacity", 1.0)
                closed_sub = [sp for sp in subpaths if sp[1]]
                if closed_sub:
                    _fill_even_odd(buf, closed_sub, (*fill, a))
            stroke = _parse_color(elem.get("stroke"))
            if stroke is not None:
                a = _f(elem, "stroke-opacity", 1.0)
                w_ = _f(elem, "stroke-width", 1.0) * s
                polys = []
                for pts, closed in subpaths:
                    polys.extend(_stroke_to_polys(pts, w_, closed))
                _fill_even_odd(buf, polys, (*stroke, a), union=True)
        elif tag == "text":
            fill = _parse_color(elem.get("fill", "black"))
            if fill is None:
                continue
            size = _f(elem, "font-size", 12.0) * s
            x, y = _f(elem, "x") * s, _f(elem, "y") * s
            anchor = elem.get("text-anchor", "start")
            rotate = None
            tr = elem.get("transform", "")
            m = re.match(r"rotate\((-?[\d.]+)", tr)
            if m:
                rotate = float(m.group(1))
            polys = _text_polys(elem.text or "", x, y, size, anchor,
                                rotate)
            if polys:
                _fill_even_odd(buf, polys, (*fill, 1.0))

    if ss > 1:
        buf = buf.reshape(height, ss, width, ss, 4).mean(axis=(1, 3))
    return buf


def composite_overlay(frame: torch.Tensor, overlay: np.ndarray,
                      anchor: str = "bottom_right",
                      margin: int = 8,
                      opacity: float = 1.0) -> torch.Tensor:
    """Source-over composite an RGBA overlay into a corner of a frame.

    ``frame``: (H, W, 3|4) float tensor; ``overlay``: (h, w, 4) straight
    alpha, an array or a tensor. The overlay is clipped to fit. Returns
    a new float32 tensor on the frame's device.

    ``anchor="center"`` centers the overlay in the frame (no margin)
    — the placement of a reference diagram with
    ``align_with_parent_window`` set, which fills its parent view
    (ScatterPlotChart::updateSizeByParent — offset 0, full size).
    """
    out = frame.to(torch.float32, copy=True)
    fh, fw = out.shape[:2]
    if anchor == "center":
        margin = 0
    oh, ow = overlay.shape[:2]
    oh, ow = min(oh, fh - 2 * margin), min(ow, fw - 2 * margin)
    if oh <= 0 or ow <= 0:
        return out
    ov = torch.as_tensor(overlay[:oh, :ow], device=out.device)
    if anchor == "center":
        y0, x0 = (fh - oh) // 2, (fw - ow) // 2
    else:
        y0 = margin if "top" in anchor else fh - margin - oh
        x0 = margin if "left" in anchor else fw - margin - ow
    region = out[y0:y0 + oh, x0:x0 + ow]
    a = (ov[:, :, 3:4] * float(opacity)).clip(0.0, 1.0)
    region[:, :, :3] = ov[:, :, :3] * a + region[:, :, :3] * (1 - a)
    if region.shape[2] == 4:
        region[:, :, 3:4] = a + region[:, :, 3:4] * (1 - a)
    out[y0:y0 + oh, x0:x0 + ow] = region
    return out
