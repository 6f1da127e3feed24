"""Hierarchical-edge-bundling chord diagram (the TVCG-2024 paper core).

Counterpart of ``correrender_tpu/diagrams/heb.py``. Reference:
src/Renderers/Diagram/HEBChart.* — octree leaves of the downsampled
volume on a circle, the strongest block-pair correlations drawn as
B-spline chords bundled through the octree hierarchy, with an outer
std-dev ring. Correlations come from the batched samplers
(diagrams/sampling.py, diagrams/bayopt.py); the drawing is SVG
(diagrams/svg.py).

The member stack stays on its device: the block means, the std-dev ring
and every sampler run there, and only the per-leaf ring values and the
per-pair correlations come to the host, where the chord list, the
filters and the SVG are the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from correrender_tpu_torch.diagrams.bayopt import batched_bayesian_opt_max
from correrender_tpu_torch.diagrams.octree import (
    GridRegion,
    Octree,
    downsample_fields,
    nanmean_exact,
)
from correrender_tpu_torch.diagrams.sampling import (
    SAMPLING_METHODS,
    as_stack,
    batched_block_pairs_max,
    request_chunk_size,
)
from correrender_tpu_torch.diagrams.svg import SvgCanvas
from correrender_tpu_torch.ops.registry import correlate


def _bspline(points: np.ndarray, samples: int = 32) -> np.ndarray:
    """Uniform cubic B-spline through control points (open, clamped).

    Reference draws chords with BSpline.cpp; same curve family.
    """
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n == 2:
        t = np.linspace(0, 1, samples)[:, None]
        return pts[0] * (1 - t) + pts[1] * t
    # Clamp ends by repeating endpoints.
    ctrl = np.concatenate([pts[:1], pts[:1], pts, pts[-1:], pts[-1:]])
    out = []
    segs = len(ctrl) - 3
    for s in np.linspace(0, segs - 1e-9, samples):
        i = int(s)
        t = s - i
        p0, p1, p2, p3 = ctrl[i : i + 4]
        b0 = (1 - t) ** 3 / 6
        b1 = (3 * t**3 - 6 * t**2 + 4) / 6
        b2 = (-3 * t**3 + 3 * t**2 + 3 * t + 1) / 6
        b3 = t**3 / 6
        out.append(b0 * p0 + b1 * p1 + b2 * p2 + b3 * p3)
    return np.asarray(out)


def _nanstd_members(means: torch.Tensor) -> torch.Tensor:
    """``numpy.nanstd`` over the member axis (ddof 0)."""
    mu = nanmean_exact(means, -1)[..., None]
    return torch.sqrt(nanmean_exact((means - mu) ** 2, -1))


class HEBChart:
    """Chord diagram over an octree of the downsampled volume."""

    def __init__(
        self,
        stack,
        downsample_factor: int | tuple = 8,
        measure: str = "pearson",
        sampling_method: str = "mean",
        num_samples: int = 64,
        max_chords: int = 100,
        threshold: float = 0.0,
        octree_mode: str = "topdown",
        correlation_range: tuple | None = None,
        cell_distance_range: tuple | None = None,
        color_map: str = "coolwarm",
        color_map_variance: str = "viridis",
        bayesian_screening: bool = True,
        screening_top_frac: float = 0.1,
        **measure_kw,
    ):
        """Args beyond the basics:

        stack: ``(Z, Y, X, n)`` member stack; a tensor stays on its
          device (an array becomes a CPU tensor).
        downsample_factor: scalar, or per-axis ``(fx, fy, fz)`` — the
          reference's ``downscaling_factor_x/y/z`` knobs
          (DiagramRenderer.cpp settings).
        correlation_range: ``(lo, hi)`` filter on the SIGNED
          correlation values kept as chords (reference
          ``correlation_range_lower/upper``); default
          ``(threshold, +inf)``.
        cell_distance_range: ``(lo, hi)`` Euclidean distance filter
          between downsampled leaf centers — pairs outside the range
          are skipped BEFORE sampling (HEBChartCorrelation.cpp:532-537).
        color_map / color_map_variance: named colormaps for the chord
          values and the std-dev outer ring (DiagramRenderer.cpp:
          1642-1670); any name from ``diagrams.colormaps``.

        ``sampling_method`` defaults to ``"mean"``, as in the JAX
        package; the reference app's default is quasirandom plastic
        (ROADMAP C).
        """
        self.stack = as_stack(stack)
        if isinstance(downsample_factor, (tuple, list)):
            fx, fy, fz = (max(1, int(v)) for v in downsample_factor)
        else:
            fx = fy = fz = max(1, int(downsample_factor))
        self.factors = (fx, fy, fz)
        #: Scalar factor for callers that halve it per drill level
        #: (drilldown.py); the max axis preserves that behavior.
        self.factor = max(fx, fy, fz)
        self.measure = measure
        self.sampling_method = sampling_method
        self.num_samples = num_samples
        self.max_chords = max_chords
        self.threshold = threshold
        self.correlation_range = (
            tuple(float(v) for v in correlation_range)
            if correlation_range is not None
            else (float(threshold), float("inf"))
        )
        self.cell_distance_range = (
            tuple(float(v) for v in cell_distance_range)
            if cell_distance_range is not None
            else None
        )
        #: (z, y, x) crop offset of this chart's stack within the full
        #: volume — drilled focus charts set it so tooltips/labels
        #: report absolute voxel coordinates. Analysis is unaffected.
        self.offset = (0, 0, 0)
        self.color_map = str(color_map)
        self.color_map_variance = str(color_map_variance)
        self.bayesian_screening = bool(bayesian_screening)
        self.screening_top_frac = float(screening_top_frac)
        self.measure_kw = measure_kw

        #: ``(zs, ys, xs, n)`` block means, on the stack's device.
        self.means = downsample_fields(self.stack, (fz, fy, fx))
        zs, ys, xs, _ = self.means.shape
        self.octree = Octree(xs, ys, zs, leaf_size=1, mode=octree_mode)
        self.leaves = self.octree.leaves
        self.num_leaves = len(self.leaves)
        self.chords: list[tuple[int, int, float]] = []
        self.leaf_stddev = self._leaf_stddev()

    def _leaf_of_cell(self) -> np.ndarray:
        """``(zs, ys, xs)`` leaf index of every downsampled cell."""
        zs, ys, xs = self.means.shape[:3]
        owner = np.full((zs, ys, xs), -1, np.int64)
        for k, r in enumerate(self.leaves):
            owner[r.z_min : r.z_max + 1, r.y_min : r.y_max + 1,
                  r.x_min : r.x_max + 1] = k
        return owner

    def _leaf_stddev(self) -> np.ndarray:
        """Per-leaf mean ensemble std-dev (the outer ring data), reduced
        on the device; only the L leaf values come to the host."""
        std = _nanstd_members(self.means).reshape(-1)  # (cells,)
        owner = torch.as_tensor(self._leaf_of_cell().reshape(-1),
                                device=std.device)
        ok = torch.isfinite(std) & (owner >= 0)
        idx = torch.where(ok, owner, 0)
        sums = torch.zeros(self.num_leaves, dtype=torch.float64,
                           device=std.device).index_add_(
            0, idx, torch.where(ok, std, 0.0).double())
        counts = torch.zeros(self.num_leaves, dtype=torch.float64,
                             device=std.device).index_add_(
            0, idx, ok.double())
        # nanmean + nan_to_num: all-NaN leaves (masked cells) must not
        # NaN-poison the ring normalization.
        vals = (sums / counts).to(torch.float32).cpu().numpy()
        return np.nan_to_num(vals, nan=0.0)

    # -- correlation ------------------------------------------------------

    def _mean_pair_values(self, iu: np.ndarray, ju: np.ndarray) -> np.ndarray:
        """The mean method: each leaf's block-mean series at its centre
        cell, correlated pair by pair in request chunks on the device."""
        centers = np.array([
            [int(round(r.center[2])), int(round(r.center[1])),
             int(round(r.center[0]))] for r in self.leaves])
        zs, ys, xs, n = self.means.shape
        flat_idx = (centers[:, 0] * ys + centers[:, 1]) * xs + centers[:, 2]
        dev = self.means.device
        series = self.means.reshape(-1, n)[torch.as_tensor(flat_idx,
                                                           device=dev)]
        kw = dict(self.measure_kw)
        absolute = kw.pop("absolute", True)
        chunk = request_chunk_size(self.measure, n, dev,
                                   kw.get("num_bins", 80))
        ia = torch.as_tensor(iu, device=dev)
        ja = torch.as_tensor(ju, device=dev)
        out = [correlate(series[ia[c:c + chunk]], series[ja[c:c + chunk]],
                         self.measure, absolute=absolute, **kw)
               for c in range(0, len(iu), chunk)]
        return torch.cat(out).cpu().numpy()

    def candidate_pairs(self):
        """The leaf pairs ``(iu, ju)`` (i < j) the chart samples: every
        pair, or those whose downsampled-cell centers lie within
        ``cell_distance_range`` (skipped before any sampling work,
        HEBChartCorrelation.cpp:532-537)."""
        iu, ju = np.triu_indices(self.num_leaves, k=1)
        if self.cell_distance_range is not None:
            lo_d, hi_d = self.cell_distance_range
            centers = np.array([r.center for r in self.leaves], np.float32)
            dist = np.linalg.norm(centers[iu] - centers[ju], axis=-1)
            m = (dist >= lo_d) & (dist <= hi_d)
            iu, ju = iu[m], ju[m]
        return iu, ju

    def pair_values(self, iu: np.ndarray, ju: np.ndarray) -> np.ndarray:
        """``(P,)`` float32 maximum correlation of each leaf pair, with
        the chart's sampling method (HEBChartCorrelation.cpp:405-421).
        The bayesian method's screening ranks the given pairs."""
        if len(iu) == 0:
            return np.zeros(0, np.float32)
        if self.sampling_method == "mean":
            return self._mean_pair_values(iu, ju)
        bounds = self._leaf_bounds()
        ra, rb = bounds[iu], bounds[ju]
        if self.sampling_method in ("random", "halton", "plastic"):
            return batched_block_pairs_max(
                self.stack, ra, rb, self.measure,
                method=self.sampling_method,
                num_samples=self.num_samples, **self.measure_kw)
        if self.sampling_method != "bayesian":
            raise ValueError(
                f"unknown sampling method {self.sampling_method!r}; "
                f"one of {sorted(SAMPLING_METHODS)}")
        num_init = min(20, self.num_samples)
        num_iters = max(self.num_samples - num_init, 0)
        P = len(iu)
        # Screening: a cheap quasirandom pass on every pair first, and
        # the GP budget only on the screening's top fraction (with ≥4×
        # max_chords margin); screened-out pairs keep their quasirandom
        # estimate.
        top_k = min(P, max(4 * self.max_chords,
                           int(np.ceil(self.screening_top_frac * P))))
        if not (self.bayesian_screening and top_k < P):
            return np.asarray(batched_bayesian_opt_max(
                self.stack, ra, rb, self.measure, num_init=num_init,
                num_iters=num_iters, **self.measure_kw), np.float32)
        screen = np.asarray(batched_block_pairs_max(
            self.stack, ra, rb, self.measure, method="plastic",
            num_samples=max(4, num_init // 2), **self.measure_kw),
            np.float32)
        top = np.argsort(-np.abs(np.nan_to_num(screen)))[:top_k]
        flat = screen.copy()
        flat[top] = np.asarray(batched_bayesian_opt_max(
            self.stack, ra[top], rb[top],
            self.measure, num_init=num_init, num_iters=num_iters,
            **self.measure_kw), np.float32)
        return flat

    def compute_correlations(self):
        """Fill ``self.chords`` with the top |corr| leaf pairs."""
        iu, ju = self.candidate_pairs()
        flat = self.pair_values(iu, ju)
        # Keep the full sampled pair set for the matrix display mode
        # (DiagramRenderer diagram_type "matrix").
        self._pair_values = (iu, ju, flat)
        self.chords = top_chords(iu, ju, flat, self.correlation_range,
                                 self.max_chords)
        return self.chords

    def _leaf_bounds(self) -> np.ndarray:
        """``(L, 6)`` full-resolution bounds of every leaf,
        ``(x_min, y_min, z_min, x_max, y_max, z_max)`` (:meth:`_upscale`'s
        regions as rows)."""
        return np.array([[r.x_min, r.y_min, r.z_min, r.x_max, r.y_max,
                          r.z_max] for r in map(self._upscale, self.leaves)],
                        np.int64).reshape(-1, 6)

    def _upscale(self, region):
        """Downsampled-leaf region → full-resolution voxel region."""
        fx, fy, fz = self.factors
        zs, ys, xs = self.stack.shape[:3]
        return GridRegion(
            region.x_min * fx,
            region.y_min * fy,
            region.z_min * fz,
            min((region.x_max + 1) * fx - 1, xs - 1),
            min((region.y_max + 1) * fy - 1, ys - 1),
            min((region.z_max + 1) * fz - 1, zs - 1),
        )

    def leaf_label(self, leaf_idx: int) -> str:
        """Absolute-voxel-coordinate label for a leaf region, shared by
        the chord-list rows and the SVG chord tooltips."""
        r = self._upscale(self.leaves[leaf_idx])
        oz, oy, ox = self.offset
        return (f"[{r.x_min + ox}-{r.x_max + ox}, "
                f"{r.y_min + oy}-{r.y_max + oy}, "
                f"{r.z_min + oz}-{r.z_max + oz}]")

    # -- layout & render --------------------------------------------------

    def _node_positions(self, radius: float, center: float):
        """Radial positions of all octree nodes (leaves on the circle,
        internal nodes at fractional radius by depth)."""
        leaf_nodes = [
            i for i, n in enumerate(self.octree.nodes) if not n.children
        ]
        leaf_angle = {
            node_idx: 2 * math.pi * k / self.num_leaves
            for k, node_idx in enumerate(leaf_nodes)
        }
        max_depth = max(n.depth for n in self.octree.nodes) or 1
        pos = {}

        def angle_of(idx):
            node = self.octree.nodes[idx]
            if not node.children:
                return leaf_angle[idx]
            return _circular_mean([angle_of(c) for c in node.children])

        for idx, node in enumerate(self.octree.nodes):
            a = angle_of(idx)
            r = radius * (node.depth / max_depth) if node.children else radius
            pos[idx] = (
                center + r * math.cos(a),
                center + r * math.sin(a),
            )
        return pos, leaf_nodes, leaf_angle

    def pair_matrix(self) -> np.ndarray:
        """Region-pair correlations as a symmetric (L, L) matrix (the
        DiagramRenderer's "matrix" display mode,
        CorrelationDefines.hpp:107-109). Distance-gated / non-finite
        pairs are NaN; the diagonal is NaN."""
        if not hasattr(self, "_pair_values"):
            self.compute_correlations()
        L = self.num_leaves
        m = np.full((L, L), np.nan, np.float32)
        iu, ju, vals = self._pair_values
        m[iu, ju] = vals
        m[ju, iu] = vals
        return m

    def render_matrix_svg(self, path: str | None = None,
                          size: int = 700) -> str:
        """Draw the matrix display mode (see :meth:`pair_matrix`)."""
        from correrender_tpu_torch.diagrams.matrix import render_matrix_svg

        return render_matrix_svg(
            self.pair_matrix(),
            labels=[f"r{i}" for i in range(self.num_leaves)],
            path=path, size=size, colormap=self.color_map,
        )

    def render_svg(
        self,
        path: str | None = None,
        size: int = 800,
        beta: float = 0.75,
        curve_thickness: float = 1.0,
        opacity_by_value: bool = True,
        curve_opacity: float = 0.8,
        outer_ring_size_pct: float = 0.06,
        highlight: tuple | None = None,
    ) -> str:
        """Draw the chart; returns the SVG text (and writes ``path``).

        ``beta`` is the bundling strength, ``curve_thickness`` a global
        line-width multiplier, and ``opacity_by_value`` maps chord
        opacity to correlation strength — when off, chords draw at the
        constant ``curve_opacity`` (DiagramRenderer.hpp:143-144).
        ``outer_ring_size_pct`` is the std-dev ring's width as a
        fraction of the chart radius (DiagramRenderer.hpp:148).
        ``highlight=(i, j)`` marks a selected leaf pair (the drilled
        chord): every other chord and ring arc desaturates and the
        selected leaves' dots take the selection colors."""
        # render.tf imports this package (its colormaps).
        from correrender_tpu_torch.render.tf import TransferFunction

        hl = tuple(sorted(int(v) for v in highlight)) if highlight \
            else None
        canvas = SvgCanvas(size, size)
        center = size / 2
        radius = size * 0.38
        pos, leaf_nodes, leaf_angle = self._node_positions(radius, center)

        # Std-dev outer ring.
        smax = float(np.nanmax(self.leaf_stddev))
        if not np.isfinite(smax) or smax <= 0.0:
            smax = 1.0
        ring_tf = TransferFunction.from_colormap(
            self.color_map_variance, domain=(0, 1))
        lut = ring_tf.lut.cpu().numpy()
        arc = 2 * math.pi / self.num_leaves
        for k in range(self.num_leaves):
            a0 = leaf_angle[leaf_nodes[k]] - arc * 0.45
            a1 = leaf_angle[leaf_nodes[k]] + arc * 0.45
            t = self.leaf_stddev[k] / smax
            color = lut[int(t * 255)][:3]
            if hl is not None and k not in hl:
                color = 0.35 * color + 0.65 * 0.82  # desaturate
            ring_w = radius * max(float(outer_ring_size_pct), 0.0)
            canvas.arc_ring(
                center, center, radius * 1.04,
                radius * 1.04 + max(ring_w, 1e-3), a0, a1,
                fill=tuple(color),
            )

        # Chords, weakest first so the strongest draw on top. Signed
        # charts rank/style by magnitude and map color over [-1, 1].
        cmap = TransferFunction.from_colormap(
            self.color_map, domain=(0, 1))
        clut = cmap.lut.cpu().numpy()
        signed = any(c[2] < 0.0 for c in self.chords)
        for i, j, value in sorted(self.chords, key=lambda c: abs(c[2])):
            path_nodes = self._bundle_path(leaf_nodes[i], leaf_nodes[j])
            pts = np.array([pos[n] for n in path_nodes])
            # β-bundling: blend control points toward the straight line.
            t = np.linspace(0, 1, len(pts))[:, None]
            straight = pts[0] * (1 - t) + pts[-1] * t
            ctrl = beta * pts + (1 - beta) * straight
            curve = _bspline(ctrl, samples=48)
            cv = (value + 1.0) * 0.5 if signed else value
            color = clut[int(np.clip(cv, 0.0, 1.0) * 255)][:3]
            mag = min(abs(value), 1.0)
            width = (0.5 + 2.0 * mag) * curve_thickness
            opacity = ((0.35 + 0.6 * mag) if opacity_by_value
                       else float(curve_opacity))
            if hl is not None:
                if tuple(sorted((i, j))) == hl:
                    width *= 1.6
                    opacity = 1.0
                else:
                    color = 0.3 * color + 0.7 * 0.85
                    opacity *= 0.35
            canvas.path(
                curve, color=tuple(color),
                width=width, opacity=opacity,
                tooltip=(f"{self.leaf_label(i)} ↔ "
                         f"{self.leaf_label(j)}: {value:.4f}"),
            )

        # Leaf dots; selection colors match the 3D region outlines.
        for k, n in enumerate(leaf_nodes):
            if hl is not None and k in hl:
                fill = ((0.95, 0.55, 0.15) if k == hl[0]
                        else (0.2, 0.8, 0.95))
                canvas.circle(pos[n][0], pos[n][1], 4.0, fill=fill)
            else:
                canvas.circle(pos[n][0], pos[n][1], 2.2,
                              fill=(0.2, 0.2, 0.25))

        if path:
            canvas.save(path)
        return canvas.to_svg()

    def _bundle_path(self, node_a: int, node_b: int) -> list[int]:
        """Node path a → LCA → b through the octree."""
        def ancestors(idx):
            out = [idx]
            while self.octree.nodes[idx].parent_idx >= 0:
                idx = self.octree.nodes[idx].parent_idx
                out.append(idx)
            return out

        up_a = ancestors(node_a)
        up_b = ancestors(node_b)
        set_a = set(up_a)
        lca = next(n for n in up_b if n in set_a)
        path = up_a[: up_a.index(lca) + 1]
        down_b = up_b[: up_b.index(lca)]
        return path + down_b[::-1]


def top_chords(iu, ju, flat, correlation_range, max_chords: int) -> list:
    """The chart's chords ``(i, j, value)``: pairs whose finite value
    lies in ``correlation_range``, ranked by magnitude (identical to the
    value on absolute charts; keeps the strongest anti-correlations on
    signed charts), at most ``max_chords``."""
    lo_c, hi_c = correlation_range
    ok = np.isfinite(flat) & (flat >= lo_c) & (flat <= hi_c)
    order = np.argsort(-np.where(ok, np.abs(flat), -np.inf))
    return [(int(iu[k]), int(ju[k]), float(flat[k]))
            for k in order[:max_chords] if ok[k]]


def _circular_mean(angles) -> float:
    s = sum(math.sin(a) for a in angles)
    c = sum(math.cos(a) for a in angles)
    return math.atan2(s, c)
