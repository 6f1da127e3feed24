"""Interactive browser viewer: the reference GUI's analogue.

Counterpart of ``correrender_tpu/app/viewer.py``. The reference app is
an ImGui/Vulkan frame loop with a property editor (src/MainApp.cpp:660,
1758), mouse picking of the correlation reference point
(src/Calculators/PointPicker.*) and camera checkpoints
(MainApp.cpp:2045). Here it is a stdlib HTTP server and a single-page
browser client: drag to orbit, wheel to zoom, shift+click (or the Pick
toggle) to move the reference point, and a panel for the measure, field,
colormap, time step, member and renderer. Every interaction renders
through the :class:`~correrender_tpu_torch.app.state.Scene` on the
volume's device; a single-DVR view of a correlation field takes
:func:`~correrender_tpu_torch.render.pipeline.render_correlation_fast`
instead, so a moved reference point is one Pearson field (K1), one
classification (K2), one composite (K3) and the warp.

A frame on a CUDA scene launches the kernels or fails: nothing falls
back to a plain version or to the CPU. Render errors reach the client as
an HTTP 500 with a JSON body.

Concurrency: the Scene's mutable state lives behind one lock; the client
keeps one request in flight, so the lock only guards against concurrent
browsers. The heavy diagrams and the HEB drill-down run off that lock,
on the member stack's device.

Usage::

    python -m correrender_tpu_torch.app.cli view --dataset data.nc \\
        --measure pearson --ref 8,8,4 --port 8777

or programmatically::

    from correrender_tpu_torch.app.viewer import serve
    serve(scene)            # blocks; ctrl-C to stop
"""

from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from correrender_tpu_torch.app.camera_path import encode_png
from correrender_tpu_torch.render.camera import Camera, orbit_camera
from correrender_tpu_torch.utils.profiling import zone

_EPS_PHI = 0.05  # keep the orbit off the poles (up-vector degeneracy)

#: The keys of :attr:`ViewerApp.last_frame_timing`.
_TIMING_KEYS = ("render_ms", "overlay_ms", "encode_ms", "total_ms")


def _spherical_from_camera(cam: Camera):
    """(theta, phi, radius, center) matching :func:`orbit_camera`."""
    c = np.asarray(cam.look_at_point, np.float64)
    p = np.asarray(cam.position, np.float64)
    d = p - c
    r = float(np.linalg.norm(d))
    if r < 1e-9:
        return 0.0, 0.0, 0.8, tuple(c)
    phi = math.asin(max(-1.0, min(1.0, d[1] / r)))
    theta = math.atan2(d[0], d[2])
    return theta, phi, r, tuple(float(v) for v in c)


def _on_device(device: torch.device):
    """Make ``device`` current in a handler thread (a new thread's CUDA
    device is 0, whatever the scene's)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ViewerApp:
    """Server-side state: one Scene, the camera orbit and the render
    settings.

    Every mutating or rendering entry point takes ``self._lock``: the
    browser client keeps one request in flight, the lock makes concurrent
    clients safe (renders serialize; the last write wins).
    """

    def __init__(self, scene, image_size=(800, 600), fast_dvr=True,
                 view: int = 0):
        self.scene = scene
        self.image_size = tuple(int(v) for v in image_size)
        self.fast_dvr = bool(fast_dvr)
        self.view = int(view)
        self.show_legend = True
        self.show_reference_points = True
        self.pick_mode = False
        self.colormap = "coolwarm"
        # The panel's opacity control points [(pos, alpha)]; None → the
        # measure-derived default (diverging or ramp).
        self.opacity_points = None
        # Colour control points [(pos, (r, g, b))]; None → the named
        # colormap above. The reference's TF widget edits both lists.
        self.color_points = None
        theta, phi, radius, center = _spherical_from_camera(
            scene.views[self.view])
        self._theta, self._phi = theta, phi
        self._radius, self._center = radius, center
        self._lock = threading.Lock()
        self._frame_epoch = 0
        self._frame_cache = None
        self._pick_hit = None
        self.last_frame_timing = {}
        # The HEB drill-down session (the reference DiagramRenderer's
        # stack): mutated only under _heb_lock; the frame path reads its
        # levels list without it (a frame racing a drill shows the state
        # before or after it).
        self._heb_lock = threading.Lock()
        self._drilldown = None
        self._drilldown_key = None
        self._heb_epoch = 0
        self._diagram_cache = None

    # -- camera ------------------------------------------------------------

    def _apply_camera(self):
        old = self.scene.views[self.view]
        self.scene.views[self.view] = orbit_camera(
            self._theta, self._phi, self._radius, self._center,
            fovy=old.fovy, z_near=old.z_near, z_far=old.z_far,
        )

    def _set_orbit_from_view(self):
        theta, phi, radius, center = _spherical_from_camera(
            self.scene.views[self.view])
        self._theta, self._phi = theta, phi
        self._radius, self._center = radius, center

    # -- calculators and transfer functions --------------------------------

    def _correlation_calcs(self):
        return [
            c for c in self.scene.volume_data.calculators.values()
            if hasattr(c, "set_reference_point")
        ]

    def _tf_targets(self):
        """The fields whose TFs the panel edits: calculator outputs, else
        the fields the renderers draw."""
        calcs = self._correlation_calcs()
        return ([c.output_name for c in calcs]
                or [r.get("field") for r in self.scene.renderers
                    if r.get("field")])

    def _rebuild_tfs(self):
        """Derive every target TF anew from the panel's colormap and
        control points (the TF editor's state)."""
        from correrender_tpu_torch.render.tf import (
            TransferFunction,
            default_opacity_points,
        )

        scene, vd = self.scene, self.scene.volume_data
        for field in self._tf_targets():
            lo, hi = vd.get_min_max(
                field, scene.current_time, scene.current_member)
            pts = self.opacity_points
            if pts is None:
                pts = default_opacity_points(lo, hi)
            if self.color_points is not None:
                tf = TransferFunction.from_control_points(
                    self.color_points, pts, domain=(lo, hi),
                    interpolate_linear_rgb=True, device=vd.device)
            else:
                tf = TransferFunction.from_colormap(
                    self.colormap, domain=(lo, hi), opacity_points=pts,
                    device=vd.device)
            scene.transfer_functions[field] = tf

    def _effective_opacity_points(self):
        """The opacity curve the next rebuild would use (for the client's
        TF editor): the custom points, else the default of the first
        target field."""
        from correrender_tpu_torch.render.tf import default_opacity_points

        if self.opacity_points is not None:
            return [list(p) for p in self.opacity_points]
        targets = self._tf_targets()
        if not targets:
            return [[0.0, 0.0], [1.0, 0.8]]
        try:
            lo, hi = self.scene.volume_data.get_min_max(
                targets[0], self.scene.current_time,
                self.scene.current_member)
        except Exception:
            return [[0.0, 0.0], [1.0, 0.8]]
        return [list(p) for p in default_opacity_points(lo, hi)]

    #: Volume renderer types the panel switches between (the outline and
    #: the world map keep their own entries).
    _VOLUME_RENDERERS = ("dvr", "iso_ray", "iso_raster", "slice")

    def _volume_renderers(self):
        return [r for r in self.scene.renderers
                if r["type"] in self._VOLUME_RENDERERS
                and r["view"] == self.view]

    # -- rendering -----------------------------------------------------------

    def _fused_dvr_job(self):
        """(calc, renderer) when the view is one DVR of a correlation field
        in the shape :func:`render_correlation_fast` covers, else None
        (the frame then goes through ``Scene.render_view``)."""
        from correrender_tpu_torch.calculators.correlation import (
            CorrelationCalculator,
        )
        from correrender_tpu_torch.render.dvr_fast import shearwarp_viable

        scene, vd = self.scene, self.scene.volume_data
        if not self.fast_dvr:
            return None
        rs = [r for r in scene.renderers if r["view"] == self.view]
        if len(rs) != 1 or rs[0]["type"] != "dvr":
            return None
        r = rs[0]
        calc = vd.calculators.get(r.get("field", ""))
        if (not isinstance(calc, CorrelationCalculator)
                or not calc.ensemble_mode
                or calc.symmetric_fields
                or calc.use_time_lag_correlations
                or calc.use_render_restriction):
            return None
        fname = calc.field_name or vd.field_names[0]
        if (calc.field_name_ref or fname) != fname:
            return None  # separate fields: the series is not stack[z, y, x]
        if getattr(vd, "model_matrix", None) is not None:
            return None
        if r.get("nan_mode", "ignore") != "ignore":
            return None
        if not shearwarp_viable(scene.views[self.view],
                                vd.grid.render_box()):
            return None
        return calc, r

    def _render_fused(self, calc, renderer) -> torch.Tensor:
        """The device part of a fused frame, without overlays (those are
        drawn on the host, see :meth:`frame_png`)."""
        from correrender_tpu_torch.render.pipeline import (
            render_correlation_fast,
        )

        scene, vd = self.scene, self.scene.volume_data
        tf = scene.tf_for(calc.output_name)  # its domain derived once
        fname = calc.field_name or vd.field_names[0]
        stack = vd.get_member_stack(fname, scene.current_time)
        return render_correlation_fast(
            stack, calc.reference_point, scene.views[self.view], tf,
            calc.measure, image_size=self.image_size,
            attenuation=renderer.get("attenuation", 100.0),
            background=(0.0, 0.0, 0.0, 0.0),
            intermediate_scale=1.0,  # the Scene's quality
            num_bins=calc.num_bins, k=calc.k,
            kraskov_estimator=calc.kraskov_estimator,
            absolute=calc.absolute,
        )

    def _frame_state_key(self):
        """Everything a frame depends on: an unchanged key means the
        cached PNG is current (the client polls /frame after every op).
        Every mutating op bumps ``_frame_epoch``, so the epoch covers the
        camera, calculator, TF and renderer state."""
        return (self._frame_epoch, self.image_size, self.fast_dvr,
                self.show_reference_points, self.show_legend)

    def frame_png(self) -> bytes:
        """The current view as PNG bytes (cached while nothing changed)."""
        return self._frame()[0]

    def _frame(self):
        """``(png, timing)``: the frame and what this call cost the
        server. A cache hit costs nothing and records a zeroed timing."""
        t_start = time.perf_counter()
        with self._lock:
            scene, vd = self.scene, self.scene.volume_data
            # Debug mode: recompute every frame (the reference's
            # continuousRecompute, CorrelationCalculator.cpp:185).
            continuous = [c for c in vd.calculators.values()
                          if getattr(c, "continuous_recompute", False)]
            for calc in continuous:
                vd.mark_dirty(calc.output_name)
            key = self._frame_state_key()
            cached = self._frame_cache
            if cached is not None and cached[0] == key and not continuous:
                self.last_frame_timing = dict.fromkeys(_TIMING_KEYS, 0.0)
                return cached[1], self.last_frame_timing
            with zone("viewer.frame"):
                job = self._fused_dvr_job()
                if job is not None:
                    img = self._render_fused(*job)
                else:
                    # The overlays are drawn on the host below on both
                    # paths.
                    img = scene.render_view(
                        self.view, image_size=self.image_size,
                        fast_dvr=self.fast_dvr,
                        show_reference_points=False, show_legend=False,
                    )
                # Quantized on the device: one byte a channel crosses to
                # the host. The overlays then draw on the quantized frame,
                # which is quantized again for the PNG (the JAX viewer's
                # order).
                u8 = (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
                arr = u8.cpu().numpy().astype(np.float32) / 255.0
            t_render = time.perf_counter()
            with zone("viewer.overlay"):
                arr = self._draw_overlays(arr, img.device)
            t_overlay = time.perf_counter()
            with zone("viewer.encode"):
                png = encode_png((arr * 255.0 + 0.5).astype(np.uint8),
                                 level=1)
            self._frame_cache = (key, png)
            t_end = time.perf_counter()
            # The server's split of the frame: render = the device work,
            # its sync and the copy; overlay = markers, outlines, legend;
            # encode = PNG. A client subtracts total_ms from its round
            # trip to get the link's share.
            self.last_frame_timing = {
                "render_ms": round((t_render - t_start) * 1e3, 1),
                "overlay_ms": round((t_overlay - t_render) * 1e3, 1),
                "encode_ms": round((t_end - t_overlay) * 1e3, 1),
                "total_ms": round((t_end - t_start) * 1e3, 1),
            }
            return png, self.last_frame_timing

    def _live_drill_level(self):
        """The last drill-down level, or None when there is none or its
        stack no longer matches the scene's field, measure or time (the
        diagram endpoint stops serving it then, and the outlines go with
        it)."""
        dd = self._drilldown
        # One read of the levels list: a heb_pop between a depth check
        # and the read would hand back the pair-less root level.
        last = dd.levels[-1] if dd is not None else None
        if last is None:
            return None
        key = self._drilldown_key
        vd = self.scene.volume_data
        measures = ({c.measure.value for c in self._correlation_calcs()}
                    or {"pearson"})
        if (key is None or key[2] != self.scene.current_time
                or key[0] not in vd.field_names or key[1] not in measures):
            return None
        return last

    def _draw_overlays(self, arr: np.ndarray, device) -> np.ndarray:
        """The reference-point markers, the drilled regions' outlines and
        the legend over the host frame ``arr`` (float32 RGBA)."""
        from correrender_tpu_torch.render.legend import color_legend_overlay
        from correrender_tpu_torch.render.picking import (
            overlay_reference_point_marker_np,
        )

        scene, vd = self.scene, self.scene.volume_data
        cam = scene.views[self.view]
        if self.show_reference_points:
            box = vd.grid.render_box()
            for calc in vd.calculators.values():
                point = getattr(calc, "reference_point", None)
                if point is not None:
                    overlay_reference_point_marker_np(
                        arr, cam, point, vd.grid.shape_zyx, box)
        level = self._live_drill_level()
        if level is not None and level[1] is not None:
            arr = self._draw_drill_outlines(arr, level[1], device)
        if self.show_legend:
            for r in scene.renderers:
                if r["view"] != self.view or r["type"] not in (
                        "dvr", "slice", "iso_ray", "iso_raster"):
                    continue
                field = r.get("field", vd.field_names[0])
                arr = color_legend_overlay(arr, scene.tf_for(field))
                break
        return arr

    def _draw_drill_outlines(self, arr, pair, device) -> np.ndarray:
        """The selected region pair's boxes, orange and cyan, and the line
        between them (the reference DiagramRenderer's selection in the 3D
        view, DiagramRenderer.cpp:728-736), drawn on ``device``."""
        from correrender_tpu_torch.render.outline import (
            connecting_line_points,
            outline_render,
            segments_render,
        )

        vd = self.scene.volume_data
        cam = self.scene.views[self.view]
        box_min, box_max = vd.grid.render_box()
        g = vd.grid
        dims = np.array([g.xs, g.ys, g.zs], np.float32)
        span = np.asarray(box_max) - np.asarray(box_min)
        img = torch.from_numpy(arr).to(device)
        colors = ((0.95, 0.55, 0.15, 1.0), (0.2, 0.8, 0.95, 1.0))
        wboxes = []
        for region, color in zip(pair, colors):
            lo = np.array([region.x_min, region.y_min, region.z_min],
                          np.float32)
            hi = np.array([region.x_max + 1, region.y_max + 1,
                           region.z_max + 1], np.float32)
            wbox = (box_min + lo / dims * span, box_min + hi / dims * span)
            wboxes.append(wbox)
            img = outline_render(cam, wbox, image_size=self.image_size,
                                 color=color, base_image=img)
        if len(wboxes) == 2:
            # Two halves, so each end carries its region's colour.
            p0, p1 = connecting_line_points(*wboxes)
            mid = 0.5 * (p0 + p1)
            for (a, b), color in zip(((p0, mid), (mid, p1)), colors):
                img = segments_render(cam, a[None], b[None],
                                      image_size=self.image_size,
                                      color=color, line_width=2.5,
                                      base_image=img)
        return img.cpu().numpy()

    # -- diagrams ------------------------------------------------------------

    def diagram_svg(self, kind: str, params: dict | None = None) -> str:
        """One of the 2D analysis diagrams as SVG text (the reference
        docks them beside the 3D views); cached per (kind, params,
        epochs).

        The heavy kinds (the HEB serve, t-SNE, the time series) run off
        the app lock on a stack taken under it, so a diagram of several
        seconds does not stall the frame endpoint (two clients may both
        compute it; the last one fills the cache)."""
        params = dict(params or {})
        with self._lock:
            key = (kind, tuple(sorted(params.items())),
                   self._frame_epoch, self._heb_epoch)
            cached = self._diagram_cache
            if cached is not None and cached[0] == key:
                return cached[1]
            job = self._heavy_diagram_job(kind, params)
            if job is None:
                svg = self._diagram_locked(kind, params)
                self._diagram_cache = (key, svg)
                return svg
        svg = job()
        with self._lock:
            self._diagram_cache = (key, svg)
        return svg

    def _diagram_field_measure(self, params: dict):
        vd = self.scene.volume_data
        calcs = self._correlation_calcs()
        measure = params.get(
            "measure", calcs[0].measure.value if calcs else "pearson")
        raw = [f for f in vd.field_names if f not in vd.calculators]
        field = params.get("field") or (raw[0] if raw
                                        else vd.field_names[0])
        return field, measure, raw

    def _heavy_diagram_job(self, kind: str, params: dict):
        """A closure for the slow diagram kinds, or None.

        Called under the lock: it takes the member stack (the field cache
        is not thread-safe); the closure runs without the lock, on the
        stack's device."""
        if kind not in ("heb", "distribution", "timeseries"):
            return None
        scene, vd = self.scene, self.scene.volume_data
        field, measure, _ = self._diagram_field_measure(params)
        if kind == "timeseries":
            return self._timeseries_job(vd, field, measure, params)
        stack = vd.get_member_stack(field, scene.current_time)

        if kind == "heb":
            defaults = self._heb_defaults()

            def _pair(key):
                v = params.get(key)
                if not v:
                    return None
                return tuple(float(x) for x in str(v).split(","))

            corr_range = _pair("correlation_range")
            dist_range = _pair("cell_distance_range")
            size = int(params.get("size", 700))
            # A drill-down session owns the HEB view: serve its current
            # chart while its key still matches the scene and the request
            # filters no chords (the drill stack is built unfiltered).
            dd = self._drilldown
            if (dd is not None and corr_range is None
                    and dist_range is None
                    and self._drilldown_key == self._heb_key(
                        params, field, measure, scene.current_time)):
                if str(params.get("context", "")) in ("1", "true"):
                    # The parent chart with the drilled chord highlighted.
                    return lambda: dd.render_context_svg(size=size)
                return lambda: dd.current_chart().render_svg(size=size)

            key = self._heb_key(params, field, measure, scene.current_time)

            def job():
                from correrender_tpu_torch.diagrams.heb import HEBChart

                with _on_device(stack.device):
                    chart = HEBChart(
                        stack,
                        downsample_factor=key[3],
                        measure=measure,
                        sampling_method=key[5],
                        num_samples=key[4],
                        max_chords=key[6],
                        correlation_range=(corr_range
                                           or defaults["correlation_range"]),
                        cell_distance_range=(
                            dist_range or defaults["cell_distance_range"]),
                        color_map=str(params.get(
                            "color_map", defaults["color_map"])),
                        color_map_variance=str(params.get(
                            "color_map_variance",
                            defaults["color_map_variance"])),
                    )
                    chart.compute_correlations()
                return chart.render_svg(size=size)
        else:
            def job():
                from correrender_tpu_torch.diagrams.distribution_similarity \
                    import distribution_similarity
                from correrender_tpu_torch.diagrams.scatter import (
                    render_scatter_svg,
                )

                with _on_device(stack.device):
                    emb, labels, _ = distribution_similarity(
                        stack,
                        max_points=int(params.get("max_points", 512)))
                return render_scatter_svg(
                    emb[:, 0], emb[:, 1],
                    labels=("t-SNE 1", "t-SNE 2"), colors=labels)

        return job

    def _timeseries_job(self, vd, field, measure, params: dict):
        """Region-mean series over the time axis and their pairwise
        correlation heat map (the reference's TimeSeriesCorrelation
        renderer for multi-timestep data). The time steps' fields are
        stacked on the device under the app lock; the closure correlates
        and renders without it."""
        g = vd.grid
        if g.ts < 2:
            raise ValueError(
                "timeseries diagram needs a multi-timestep "
                f"dataset (ts={g.ts})")
        member = self.scene.current_member
        # (Z, Y, X, T): the time axis rides the member slot of
        # downsample_fields.
        fvol = torch.stack([vd.get_field(field, t, member)
                            for t in range(g.ts)], dim=-1)
        default_f = max(min(g.xs, g.ys) // 4, 1)
        f = int(params.get("downsample", default_f))
        window = params.get("window")

        def job():
            from correrender_tpu_torch.diagrams.octree import (
                downsample_fields,
            )
            from correrender_tpu_torch.diagrams.timeseries import (
                render_heatmap_svg,
                time_series_correlation,
            )

            with _on_device(fvol.device):
                series = downsample_fields(fvol, f).reshape(-1, g.ts)
                series = series[torch.isfinite(series).all(dim=1)]
                if series.shape[0] == 0:
                    raise ValueError(
                        "timeseries diagram: no downsampled cell is "
                        "finite across all timesteps (masked/NaN data) — "
                        "try a larger 'downsample' factor")
                if series.shape[0] > 128:
                    # An even stride, not the first 128 rows: those would
                    # all lie in the lowest z slab (the rows are z-major).
                    idx = np.linspace(0, series.shape[0] - 1, 128)
                    series = series[torch.as_tensor(
                        idx.round().astype(np.int64), device=series.device)]
                m = time_series_correlation(
                    series, measure,
                    window=int(window) if window else None)
                lo, hi = float(m.min()), float(m.max())
            domain = (-1.0, 1.0) if lo < 0 else (0.0, max(hi, 1e-6))
            return render_heatmap_svg(m, domain=domain)

        return job

    def _diagram_locked(self, kind: str, params: dict) -> str:
        scene, vd = self.scene, self.scene.volume_data
        field, measure, raw = self._diagram_field_measure(params)
        if kind == "matrix":
            from correrender_tpu_torch.diagrams.matrix import (
                field_correlation_matrix,
                render_matrix_svg,
            )

            m, names = field_correlation_matrix(
                vd, raw or None, time=scene.current_time, measure=measure)
            return render_matrix_svg(m, labels=names)
        if kind == "scatter":
            from correrender_tpu_torch.diagrams.scatter import (
                render_scatter_svg,
            )

            field_b = params.get("field_b") or field
            a = vd.get_field(field, scene.current_time,
                             scene.current_member).cpu().numpy()
            b = vd.get_field(field_b, scene.current_time,
                             scene.current_member).cpu().numpy()
            return render_scatter_svg(a, b, labels=(field, field_b))
        raise ValueError(
            f"unknown diagram kind {kind!r}; one of "
            "heb/matrix/distribution/scatter/timeseries")

    # -- the JSON command surface --------------------------------------------

    def info(self) -> dict:
        from correrender_tpu_torch.ops.registry import MEASURE_IDS
        from correrender_tpu_torch.render.tf import _COLORMAPS

        vd = self.scene.volume_data
        g = vd.grid
        calcs = self._correlation_calcs()
        return {
            "grid": {"xs": g.xs, "ys": g.ys, "zs": g.zs,
                     "ts": g.ts, "es": g.es},
            "fields": vd.field_names,
            "derived_fields": list(vd.calculators),
            "measures": [m.value for m in MEASURE_IDS],
            "colormaps": list(_COLORMAPS),
            "renderers": [dict(r) for r in self.scene.renderers],
            "time": self.scene.current_time,
            "member": self.scene.current_member,
            "image_size": list(self.image_size),
            "fast_dvr": self.fast_dvr,
            "legend": self.show_legend,
            "pick_mode": self.pick_mode,
            "measure": (calcs[0].measure.value if calcs else None),
            "absolute": (bool(calcs[0].absolute) if calcs else None),
            "reference_point": (list(calcs[0].reference_point)
                                if calcs else None),
            "colormap": self.colormap,
            "opacity_points": self._effective_opacity_points(),
            "opacity_default": self.opacity_points is None,
            "color_points": ([[p, list(c)] for p, c in self.color_points]
                             if self.color_points is not None else None),
            "camera": {"theta": self._theta, "phi": self._phi,
                       "radius": self._radius},
            "checkpoints": sorted(self.scene.camera_checkpoints),
            "view": self.view,
            "num_views": len(self.scene.views),
            "frame_epoch": self._frame_epoch,
            # The HEB knobs' defaults (a loaded state's diagram node
            # wins), so the client's panel opens as the session is set.
            "heb_defaults": {
                k: (list(v) if isinstance(v, tuple) else v)
                for k, v in self._heb_defaults().items()
            },
        }

    def api(self, cmd: dict) -> dict:
        """Dispatch one client command; returns a JSON-able reply."""
        if cmd.get("op") in ("heb_chords", "heb_drill", "heb_pop",
                             "heb_reset"):
            # Chart builds: serialized by _heb_lock, off the app lock so
            # frames keep serving during a drill.
            reply = self._heb_api(dict(cmd))
        else:
            with self._lock:
                reply = self._api_locked(dict(cmd))
        reply.setdefault("ok", True)
        return reply

    # -- HEB drill-down (the reference DiagramRenderer's selection stack) --

    def _bump_heb(self, frame: bool = True):
        with self._lock:
            self._heb_epoch += 1
            if frame:
                self._frame_epoch += 1

    def _heb_api(self, cmd: dict) -> dict:
        op = cmd.get("op")
        with self._heb_lock:
            if op == "heb_reset":
                with self._lock:
                    self._drilldown = None
                    self._drilldown_key = None
                    self._heb_epoch += 1
                    self._frame_epoch += 1
                return {"depth": 0, "chords": []}
            if op == "heb_pop":
                dd = self._drilldown
                if dd is None or dd.depth <= 1:
                    return {"ok": False, "error": "nothing to pop"}
                dd.pop()
                self._bump_heb()
                return self._heb_reply(dd)
            try:
                dd = self._ensure_drilldown(cmd)
            except Exception as exc:  # noqa: BLE001 — surface to the client
                return {"ok": False, "error": str(exc)}
            if op == "heb_chords":
                return self._heb_reply(dd)
            i = int(cmd.get("chord", 0))  # heb_drill
            chords = dd.current_chart().chords
            if not 0 <= i < len(chords):
                return {"ok": False,
                        "error": f"chord {i} out of range "
                                 f"({len(chords)} chords)"}
            with _on_device(dd.stack.device):
                dd.drill_into_chord(i)
            self._bump_heb()
            return self._heb_reply(dd)

    def _heb_defaults(self) -> dict:
        """The HEB knobs' defaults: a loaded scene's diagram node (e.g. an
        imported reference state's DiagramRenderer settings) overrides the
        built-ins, so ``view --state`` opens with the session's chart."""
        d = {"downsample": 4, "num_samples": 20,
             "sampling_method": "plastic", "max_chords": 250,
             "correlation_range": None, "cell_distance_range": None,
             "color_map": "coolwarm", "color_map_variance": "viridis"}
        node = next((r for r in self.scene.renderers
                     if r["type"] == "diagram" and not r.get("hidden")),
                    None)
        if node is not None:
            if "downsample_xyz" in node:
                d["downsample"] = tuple(
                    int(v) for v in node["downsample_xyz"])
            elif "downsample" in node:
                d["downsample"] = int(node["downsample"])
            for key in ("num_samples", "max_chords"):
                if key in node:
                    d[key] = int(node[key])
            if "sampling_method" in node:
                d["sampling_method"] = str(node["sampling_method"])
            for key in ("color_map", "color_map_variance"):
                if key in node:
                    d[key] = str(node[key])
            for key in ("correlation_range", "cell_distance_range"):
                if node.get(key) is not None:
                    d[key] = tuple(float(v) for v in node[key])
        return d

    def _heb_key(self, params: dict, field, measure, time):
        """The drill stack's identity. Its defaults are the plain HEB
        diagram's (both from :meth:`_heb_defaults`): the chord list and
        the displayed chart come from the two paths, and chord row k must
        point into the chart the user sees."""
        d = self._heb_defaults()
        ds = params.get("downsample")
        if ds is None:
            ds = d["downsample"]
        elif "," in str(ds):
            ds = tuple(int(v) for v in str(ds).split(","))
        else:
            ds = int(ds)
        return (field, str(measure), time, ds,
                int(params.get("num_samples", d["num_samples"])),
                str(params.get("sampling_method", d["sampling_method"])),
                int(params.get("max_chords", d["max_chords"])))

    def _ensure_drilldown(self, params: dict):
        """Build (or reuse) the drill-down stack of the current field,
        measure and time. Called under _heb_lock; the chart builds off the
        app lock, on the member stack's device."""
        from correrender_tpu_torch.diagrams.drilldown import HEBDrilldown

        scene, vd = self.scene, self.scene.volume_data
        with self._lock:
            field, measure, _ = self._diagram_field_measure(params)
            key = self._heb_key(params, field, measure, scene.current_time)
            if self._drilldown is not None and self._drilldown_key == key:
                return self._drilldown
            stack = vd.get_member_stack(field, scene.current_time)
        with _on_device(stack.device):
            dd = HEBDrilldown(
                stack, downsample_factor=key[3], measure=key[1],
                num_samples=key[4], sampling_method=key[5],
                max_chords=key[6],
            )
        with self._lock:
            self._drilldown = dd
            self._drilldown_key = key
            self._heb_epoch += 1
        return dd

    def _heb_reply(self, dd) -> dict:
        chart = dd.current_chart()
        # A drilled chart analyzes a cropped stack; leaf_label adds the
        # level's crop offset, so the labels are the absolute voxel
        # coordinates of the 3D outlines and the SVG tooltips.
        return {
            "depth": dd.depth,
            "chords": [
                {"index": k, "value": round(float(v), 4),
                 "a": chart.leaf_label(i), "b": chart.leaf_label(j)}
                for k, (i, j, v) in enumerate(chart.chords[:24])
            ],
        }

    def _api_locked(self, cmd: dict) -> dict:
        op = cmd.get("op")
        handler = self._OPS.get(op)
        if handler is None:
            return {"ok": False, "error": f"unknown op {op!r}"}
        reply = handler(self, cmd)
        if reply is not None:
            return reply
        self._frame_epoch += 1
        return {"frame_epoch": self._frame_epoch}

    # Each op returns its reply, or None for the default reply (the frame
    # epoch, bumped).

    def _op_info(self, cmd):
        return self.info()

    def _op_timing(self, cmd):
        # The server's split of the last frame (see _frame).
        return {"ok": True, **self.last_frame_timing}

    def _op_orbit(self, cmd):
        self._theta += float(cmd.get("dtheta", 0.0))
        self._phi = max(-math.pi / 2 + _EPS_PHI,
                        min(math.pi / 2 - _EPS_PHI,
                            self._phi + float(cmd.get("dphi", 0.0))))
        self._apply_camera()

    def _op_zoom(self, cmd):
        self._radius = max(0.05, min(
            20.0, self._radius * float(cmd.get("factor", 1.0))))
        self._apply_camera()

    def _move_reference(self, calcs, hit):
        from correrender_tpu_torch.render.picking import world_to_voxel

        g = self.scene.volume_data.grid
        voxel = world_to_voxel(hit["focus"], (g.zs, g.ys, g.xs),
                               g.render_box())
        for calc in calcs:
            calc.set_reference_point(*voxel)
        self._frame_epoch += 1
        return {"reference_point": [int(v) for v in voxel]}

    def _op_pick(self, cmd):
        from correrender_tpu_torch.render.picking import pick_hit_points

        calcs = self._correlation_calcs()
        if not calcs:
            return dict(_NO_CALCULATOR)
        # Clamped to the image: the client rounds, so a click in the last
        # half pixel gives px == width.
        px = max(0, min(self.image_size[0] - 1, int(cmd["px"])))
        py = max(0, min(self.image_size[1] - 1, int(cmd["py"])))
        hit = pick_hit_points(
            self.scene.views[self.view], (px, py), self.image_size,
            self.scene.volume_data.grid.render_box(),
            fixed_z_fraction=cmd.get("fixed_z_fraction"),
        )
        if hit is None:
            return {"ok": False, "error": "ray misses the volume"}
        # Kept for the wheel's depth scrub (the reference's
        # hasHitInformation, PointPicker.cpp:100-106).
        self._pick_hit = hit
        return self._move_reference(calcs, hit)

    def _op_pick_scroll(self, cmd):
        # The wheel moves the focus along the last pick ray, clamped
        # between the volume's entry and exit (PointPicker.cpp:128-135).
        from correrender_tpu_torch.render.picking import scrub_focus

        calcs = self._correlation_calcs()
        if not calcs:
            return dict(_NO_CALCULATOR)
        hit = self._pick_hit
        if hit is None:
            return {"ok": False,
                    "error": "no pick hit yet; pick a point first"}
        scrub_focus(hit, float(cmd.get("amount", 0.0)))
        return self._move_reference(calcs, hit)

    def _op_set_measure(self, cmd):
        from correrender_tpu_torch.ops.registry import measure_from_id

        scene, vd = self.scene, self.scene.volume_data
        calcs = self._correlation_calcs()
        if not calcs:
            return dict(_NO_CALCULATOR)
        measure = measure_from_id(cmd["measure"])
        for calc in calcs:
            # A default-named calculator's output is named after its
            # measure (the reference renames it): rename the registry
            # entry and every renderer and TF reference, or the old name
            # keeps serving its cached field.
            old = calc.output_name
            calc.measure = measure
            new = calc.output_name
            if new != old:
                try:
                    vd.rename_field(old, new)
                except ValueError:
                    # A second calculator already owns the name: this one
                    # keeps its current name.
                    calc._output_name = old
                    new = old
                else:
                    for r in scene.renderers:
                        if r.get("field") == old:
                            r["field"] = new
                    scene.transfer_functions.pop(old, None)
            vd.mark_dirty(new)
        # The TF's domain follows the measure's range ([-1, 1] or
        # [0, max MI]).
        self._rebuild_tfs()

    def _op_set_field(self, cmd):
        vd = self.scene.volume_data
        calcs = self._correlation_calcs()
        name = cmd["field"]
        if name not in vd.field_names:
            return {"ok": False, "error": f"unknown field {name!r}"}
        if not calcs:
            return dict(_NO_CALCULATOR)
        if name in vd.calculators:
            # A calculator's output as its own (or a sibling's) input
            # recurses at compute time.
            return {"ok": False,
                    "error": f"{name!r} is a derived field; pick "
                             "a dataset field"}
        for calc in calcs:
            # The reference field follows the query field only where it
            # did before (single mode); separate fields keep theirs.
            if (not calc.symmetric_fields
                    and calc.field_name_ref == calc.field_name):
                calc.field_name_ref = name
            calc.field_name = name
            vd.mark_dirty(calc.output_name)
        self._rebuild_tfs()

    def _op_set_colormap(self, cmd):
        from correrender_tpu_torch.render.tf import _COLORMAPS

        if cmd["colormap"] not in _COLORMAPS:
            return {"ok": False,
                    "error": f"unknown colormap {cmd['colormap']!r}"}
        self.colormap = cmd["colormap"]
        self._rebuild_tfs()

    def _op_set_tf(self, cmd):
        # The TF editor: opacity control points over the colormap, and
        # colour control points (the reference TF widget's surface).
        if "opacity_points" in cmd or "color_points" not in cmd:
            pts = cmd.get("opacity_points")
            if pts is None:
                self.opacity_points = None  # back to the default
            else:
                pts = [(float(x), float(a)) for x, a in pts]
                if (len(pts) < 2
                        or any(not (0 <= x <= 1 and 0 <= a <= 1)
                               for x, a in pts)
                        or any(b[0] < a[0] for a, b in zip(pts, pts[1:]))):
                    return {"ok": False,
                            "error": "opacity_points must be ≥2 "
                                     "(pos, alpha) pairs in [0,1], "
                                     "sorted by pos"}
                self.opacity_points = pts
        if "color_points" in cmd:
            cpts = cmd["color_points"]
            if cpts is None:
                self.color_points = None  # back to the colormap
            else:
                try:
                    cpts = [(float(p[0]),
                             (float(p[1][0]), float(p[1][1]),
                              float(p[1][2])))
                            for p in cpts]
                except (TypeError, IndexError, ValueError):
                    return {"ok": False,
                            "error": "color_points must be "
                                     "[pos, [r, g, b]] entries"}
                if (len(cpts) < 2
                        or any(not (0 <= x <= 1) for x, _ in cpts)
                        or any(not all(0 <= v <= 1 for v in c)
                               for _, c in cpts)
                        or any(b[0] < a[0] for a, b in zip(cpts, cpts[1:]))):
                    return {"ok": False,
                            "error": "color_points must be ≥2 "
                                     "[pos, [r,g,b]] in [0,1], "
                                     "sorted by pos"}
                self.color_points = cpts
        self._rebuild_tfs()

    def _op_tf_save(self, cmd):
        # The widget's sgl TF .xml export of the first target's TF.
        from correrender_tpu_torch.render.tf import tf_to_xml_string

        targets = self._tf_targets()
        if not targets:
            return {"ok": False, "error": "no TF target field"}
        xml = tf_to_xml_string(self.scene.tf_for(targets[0]))
        path = cmd.get("path")
        if path:
            with open(path, "w") as f:
                f.write(xml)
        return {"ok": True, "xml": xml, "path": path}

    def _op_tf_load(self, cmd):
        # The widget's sgl TF .xml import: the file's control points
        # become the editor's state (a tf_save then writes them back).
        from correrender_tpu_torch.render.tf import tf_from_xml_string

        xml = cmd.get("xml")
        if xml is None:
            path = cmd.get("path")
            if not path:
                return {"ok": False, "error": "tf_load needs xml or path"}
            with open(path) as f:
                xml = f.read()
        try:
            tf = tf_from_xml_string(xml)
        except Exception as exc:
            return {"ok": False, "error": f"bad TF XML: {exc}"}
        self.color_points = list(tf.color_points or []) or None
        self.opacity_points = list(tf.opacity_points or []) or None
        self._rebuild_tfs()

    def _op_set_absolute(self, cmd):
        vd = self.scene.volume_data
        calcs = self._correlation_calcs()
        if not calcs:
            return dict(_NO_CALCULATOR)
        for calc in calcs:
            calc.absolute = bool(cmd["value"])
            vd.mark_dirty(calc.output_name)
        # The domain flips between [-1, 1] and [0, 1].
        self._rebuild_tfs()

    def _op_set_renderer(self, cmd):
        kind = cmd["renderer"]
        if kind not in self._VOLUME_RENDERERS:
            return {"ok": False,
                    "error": f"unknown renderer {kind!r}; one of "
                             f"{list(self._VOLUME_RENDERERS)}"}
        targets = self._volume_renderers()
        if not targets:
            return dict(_NO_VOLUME_RENDERER)
        for r in targets:
            r["type"] = kind

    def _op_set_renderer_option(self, cmd):
        key, value = cmd["key"], cmd["value"]
        targets = self._volume_renderers()
        if not targets:
            return dict(_NO_VOLUME_RENDERER)
        if key == "iso_value":
            value = float(value)
        elif key == "attenuation":
            value = max(1.0, float(value))
        elif key == "axis":
            if value not in ("x", "y", "z"):
                return {"ok": False, "error": "axis must be x, y or z"}
        elif key == "position":
            value = min(1.0, max(0.0, float(value)))
        else:
            return {"ok": False,
                    "error": f"unknown renderer option {key!r}"}
        for r in targets:
            r[key] = value

    def _op_set_view(self, cmd):
        # Multi-view scenes (the reference's docked DataViews): the canvas
        # shows another view, its orbit taken from that view's camera.
        views = self.scene.views
        v = int(cmd["view"])
        if not 0 <= v < len(views):
            return {"ok": False,
                    "error": f"view {v} out of range ({len(views)} views)"}
        self.view = v
        self._set_orbit_from_view()

    def _op_set_time(self, cmd):
        g = self.scene.volume_data.grid
        self.scene.current_time = max(0, min(g.ts - 1, int(cmd["time"])))

    def _op_set_member(self, cmd):
        g = self.scene.volume_data.grid
        self.scene.current_member = max(0, min(g.es - 1,
                                               int(cmd["member"])))

    def _op_set_option(self, cmd):
        key, value = cmd["key"], cmd["value"]
        if key == "legend":
            self.show_legend = bool(value)
        elif key == "refpoints":
            self.show_reference_points = bool(value)
        elif key == "fast_dvr":
            self.fast_dvr = bool(value)
        elif key == "pick_mode":
            self.pick_mode = bool(value)
        elif key == "image_size":
            w, h = (int(v) for v in value)
            self.image_size = (max(64, min(3840, w)), max(48, min(2160, h)))
        elif key == "continuous_recompute":
            # Recompute the calculators every frame (the reference's
            # "Continuous Recompute", CorrelationCalculator.cpp:700).
            for calc in self.scene.volume_data.calculators.values():
                calc.continuous_recompute = bool(value)
        else:
            return {"ok": False, "error": f"unknown option {key!r}"}

    def _op_checkpoint_save(self, cmd):
        self.scene.save_camera_checkpoint(str(cmd["name"]), self.view)

    def _op_checkpoint_restore(self, cmd):
        try:
            self.scene.restore_camera_checkpoint(str(cmd["name"]),
                                                 self.view)
        except KeyError:
            return {"ok": False, "error": f"no checkpoint {cmd['name']!r}"}
        self._set_orbit_from_view()

    def _op_save_state(self, cmd):
        self.scene.save_state(str(cmd["path"]))
        return {"path": str(cmd["path"])}

    def _op_export_field(self, cmd):
        # The reference's field export (VolumeData::saveFieldToFile): any
        # field, derived ones too, by extension.
        from correrender_tpu_torch.io.writers import save_field

        scene, vd = self.scene, self.scene.volume_data
        calcs = self._correlation_calcs()
        field = cmd.get("field") or (
            calcs[0].output_name if calcs else vd.field_names[0])
        path = str(cmd["path"])
        save_field(vd, field, path, scene.current_time, scene.current_member)
        return {"path": path, "field": field}

    def _op_similarity(self, cmd):
        # The reference's "Compute Field Similarity" dialog.
        from correrender_tpu_torch.ops.similarity import (
            volume_field_similarity,
        )

        vd = self.scene.volume_data
        a = cmd.get("field_a") or vd.field_names[0]
        value = volume_field_similarity(
            vd, a, str(cmd["field_b"]),
            measure=cmd.get("measure", "pearson"),
            all_members=bool(cmd.get("all_members", False)),
        )
        return {"value": float(value), "field_a": a}

    def _op_tf_optimize(self, cmd):
        # The reference's TF-optimization dialog: fit field_dst's TF so
        # its DVR matches field_src's; the fit runs here, under the lock,
        # on the fields' device.
        from correrender_tpu_torch.optim.tf_opt import TFOptimizer

        scene, vd = self.scene, self.scene.volume_data
        src = str(cmd["field_src"])
        dst = str(cmd["field_dst"])
        opt = TFOptimizer(
            method=str(cmd.get("method", "ols")),
            tf_size=int(cmd.get("tf_size", 64)),
            epochs=int(cmd.get("epochs", 200)),
        )
        fa = vd.get_field(src, scene.current_time, scene.current_member)
        fb = vd.get_field(dst, scene.current_time, scene.current_member)
        try:
            fitted = opt.run(fa, scene.tf_for(src), fb,
                             camera=scene.views[self.view])
        except ValueError as exc:  # a bad method or tf_size
            return {"ok": False, "error": str(exc)}
        # Setting the scene's TF invalidates what it classified.
        scene.transfer_functions[dst] = fitted

    _OPS = {
        "info": _op_info,
        "timing": _op_timing,
        "orbit": _op_orbit,
        "zoom": _op_zoom,
        "pick": _op_pick,
        "pick_scroll": _op_pick_scroll,
        "set_measure": _op_set_measure,
        "set_field": _op_set_field,
        "set_colormap": _op_set_colormap,
        "set_tf": _op_set_tf,
        "tf_save": _op_tf_save,
        "tf_load": _op_tf_load,
        "set_absolute": _op_set_absolute,
        "set_renderer": _op_set_renderer,
        "set_renderer_option": _op_set_renderer_option,
        "set_view": _op_set_view,
        "set_time": _op_set_time,
        "set_member": _op_set_member,
        "set_option": _op_set_option,
        "checkpoint_save": _op_checkpoint_save,
        "checkpoint_restore": _op_checkpoint_restore,
        "save_state": _op_save_state,
        "export_field": _op_export_field,
        "similarity": _op_similarity,
        "tf_optimize": _op_tf_optimize,
    }


_NO_CALCULATOR = {"ok": False, "error": "no correlation calculator in scene"}
_NO_VOLUME_RENDERER = {"ok": False, "error": "no volume renderer in this view"}


class _Server(ThreadingHTTPServer):
    """``server_close`` joins the request threads still running."""

    daemon_threads = False


def _make_handler(app: ViewerApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102 — quiet
            pass

        def _send(self, code, ctype, body: bytes, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, doc):
            self._send(code, "application/json", json.dumps(doc).encode())

        def do_GET(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path in ("/", "/index.html"):
                self._send(200, "text/html; charset=utf-8",
                           _INDEX_HTML.encode())
            elif url.path == "/frame":
                try:
                    png, timing = app._frame()
                except Exception as e:  # render errors reach the client
                    self._send_json(500, {"error": str(e)})
                    return
                # What THIS response cost the server (0.0 from the frame
                # cache): a client subtracts it from its round trip.
                self._send(200, "image/png", png, [
                    ("X-Server-Frame-Ms", str(timing["total_ms"]))])
            elif url.path == "/diagram":
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                kind = q.pop("kind", "heb")
                q.pop("t", None)  # the client's cache-buster
                try:
                    svg = app.diagram_svg(kind, q)
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                    return
                except Exception as e:
                    self._send_json(500, {"error": str(e)})
                    return
                self._send(200, "image/svg+xml", svg.encode())
            elif url.path == "/api":
                # GET is read-only: a mutating GET would be reachable
                # cross-origin from any page (<img src=...>, no CORS
                # preflight). Mutations go by POST.
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                if q.get("op", "info") != "info":
                    self._send_json(403, {
                        "ok": False,
                        "error": "GET /api only serves op=info; "
                                 "use POST for mutations",
                    })
                    return
                self._send_json(200, app.api({"op": "info"}))
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):  # noqa: N802
            if urlparse(self.path).path != "/api":
                self._send(404, "text/plain", b"not found")
                return
            # A cross-origin POST skips the CORS preflight only with a
            # "simple" content type; requiring application/json forces a
            # preflight that is never answered.
            ctype = self.headers.get("Content-Type", "")
            if not ctype.startswith("application/json"):
                self._send_json(415, {
                    "ok": False,
                    "error": "Content-Type must be application/json",
                })
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                reply = app.api(json.loads(self.rfile.read(n) or b"{}"))
            except Exception as e:
                reply = {"ok": False, "error": str(e)}
            self._send_json(200, reply)

    return Handler


def make_server(scene, host="127.0.0.1", port=8777, **app_kwargs):
    """Build ``(server, app)`` without serving (``port=0`` takes a free
    port)."""
    app = ViewerApp(scene, **app_kwargs)
    server = _Server((host, port), _make_handler(app))
    return server, app


def serve(scene, host="127.0.0.1", port=8777, **app_kwargs):
    """Serve the viewer until interrupted, then close the server (joining
    the requests in flight) and return."""
    server, _ = make_server(scene, host, port, **app_kwargs)
    print(f"viewer: http://{host}:{server.server_address[1]}/ "
          f"(ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


# ---------------------------------------------------------------------------
# The single-page client. Plain JS, no external assets (zero egress).
# Interaction model: at most ONE request in flight; drag deltas
# accumulate client-side and flush when the previous round-trip
# finishes, so the frame rate adapts to the device's render latency.
# ---------------------------------------------------------------------------

_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>correrender_tpu viewer</title>
<style>
  body { margin:0; font:13px system-ui,sans-serif; background:#14161a;
         color:#d7dae0; display:flex; height:100vh; }
  #frame { flex:1; display:flex; align-items:center; justify-content:center;
           overflow:hidden; }
  #frame img { max-width:100%; max-height:100%; cursor:grab;
               image-rendering:auto; user-select:none; }
  #panel { width:240px; padding:12px; background:#1d2026; overflow-y:auto;
           border-left:1px solid #2c2f36; }
  #panel h1 { font-size:14px; margin:0 0 10px; color:#fff; }
  .row { margin-bottom:10px; }
  .row label { display:block; margin-bottom:3px; color:#9aa0ab; }
  select, input[type=text] { width:100%; background:#14161a; color:#d7dae0;
           border:1px solid #3a3e47; border-radius:4px; padding:4px; }
  input[type=range] { width:100%; }
  button { background:#2b5ea7; color:#fff; border:0; border-radius:4px;
           padding:5px 9px; margin-right:6px; cursor:pointer; }
  button.off { background:#3a3e47; }
  #status { color:#7b818c; min-height:2.5em; white-space:pre-wrap; }
</style></head><body>
<div id="frame" style="flex-direction:column">
  <img id="img" draggable="false" alt="volume render">
  <div id="diagdock" style="display:none;max-height:45%;overflow:auto">
    <div id="hebui" style="display:none;font-size:12px;padding:2px 6px">
      <button id="hebback">&#9664; back</button>
      <button id="hebctx" class="off" title="show the parent chart
with the drilled chord highlighted">context</button>
      <span id="hebdepth"></span>
      <div id="hebchords" style="max-height:110px;overflow:auto;
           margin-top:3px"></div>
    </div>
    <img id="diagimg" alt="diagram" style="max-width:100%;cursor:default">
  </div>
</div>
<div id="panel">
  <h1>correrender_tpu</h1>
  <div class="row" id="viewrow" style="display:none"><label>View</label>
    <select id="viewsel"></select></div>
  <div class="row"><label>Measure</label><select id="measure"></select></div>
  <div class="row"><label>Field</label><select id="field"></select></div>
  <div class="row"><label>Renderer</label><select id="renderer">
    <option>dvr</option><option>iso_ray</option>
    <option>iso_raster</option><option>slice</option>
  </select></div>
  <div class="row" id="dvrrow"><label>Attenuation
      <span id="attval"></span></label>
    <input type="range" id="atten" min="1" max="400" value="100"></div>
  <div class="row" id="isorow" style="display:none">
    <label>Iso value</label>
    <input type="text" id="isoval" value="0.5"></div>
  <div class="row" id="slicerow" style="display:none">
    <label>Slice axis / position <span id="sposval"></span></label>
    <select id="saxis" style="width:60px;display:inline-block">
      <option>x</option><option>y</option><option selected>z</option>
    </select>
    <input type="range" id="spos" min="0" max="100" value="50"></div>
  <div class="row"><label>Colormap</label><select id="colormap"></select></div>
  <div class="row"><label>Opacity (drag points, dblclick adds,
      right-click removes)</label>
    <canvas id="tfcanvas" width="214" height="70"
      style="background:#14161a;border:1px solid #3a3e47;
             border-radius:4px;touch-action:none"></canvas>
    <button id="tfreset" style="margin-top:4px">Reset curve</button>
    <canvas id="tfcolors" width="214" height="18" title="color control
      points: click a marker to recolor, shift+click adds, right-click
      removes" style="background:#14161a;border:1px solid #3a3e47;
             border-radius:4px;margin-top:4px;touch-action:none">
    </canvas>
    <input type="color" id="tfcolorpick"
      style="position:absolute;left:-9999px">
    <div style="margin-top:4px">
      <button id="tfsave" title="download the current TF as an sgl
        .xml file">Save TF</button>
      <button id="tfloadbtn" title="load an sgl TF .xml">Load TF</button>
      <input type="file" id="tfload" accept=".xml"
        style="display:none"></div></div>
  <div class="row"><label>Time step <span id="tval"></span></label>
    <input type="range" id="time" min="0" value="0"></div>
  <div class="row"><label>Member <span id="eval"></span></label>
    <input type="range" id="member" min="0" value="0"></div>
  <div class="row">
    <button id="pick" class="off">Pick ref</button>
    <button id="legend">Legend</button>
    <button id="absbtn" class="off">Abs</button>
  </div>
  <div class="row"><label>Diagram (docked below view)</label>
    <select id="diagram">
      <option value="">none</option>
      <option value="heb">HEB chords</option>
      <option value="matrix">correlation matrix</option>
      <option value="distribution">distribution similarity</option>
      <option value="scatter">scatter</option>
      <option value="timeseries">time-series correlation</option>
    </select></div>
  <div class="row"><label>Camera checkpoint</label>
    <input type="text" id="ckname" placeholder="name">
    <div style="margin-top:5px">
      <button id="cksave">Save</button>
      <select id="ckload" style="width:100px;display:inline-block">
      </select>
    </div></div>
  <div class="row"><label>Reference point</label>
    <span id="refpt">—</span></div>
  <div class="row" id="status">drag = orbit · wheel = zoom ·
shift+click = pick reference point · shift+wheel = scrub pick depth</div>
</div>
<script>
"use strict";
const img = document.getElementById("img");
let info = null, busy = false, wantFrame = false;
let pend = {dtheta:0, dphi:0, zoom:1, scrub:0};
let pickMode = false;

async function api(cmd) {
  const r = await fetch("/api", {method:"POST",
    headers:{"Content-Type":"application/json"},
    body:JSON.stringify(cmd)});
  return r.json();
}
function setStatus(s) { document.getElementById("status").textContent = s; }

async function refreshFrame() {
  wantFrame = true;
  if (busy) return;
  busy = true;
  while (wantFrame || pend.dtheta || pend.dphi || pend.zoom !== 1 ||
         pend.scrub) {
    if (pend.dtheta || pend.dphi) {
      const d = {op:"orbit", dtheta:pend.dtheta, dphi:pend.dphi};
      pend.dtheta = 0; pend.dphi = 0;
      await api(d);
    }
    if (pend.zoom !== 1) {
      const f = pend.zoom; pend.zoom = 1;
      await api({op:"zoom", factor:f});
    }
    if (pend.scrub) {
      const a = pend.scrub; pend.scrub = 0;
      const reply = await api({op:"pick_scroll", amount:a});
      if (reply.ok && reply.reference_point)
        document.getElementById("refpt").textContent =
          reply.reference_point.join(", ");
    }
    wantFrame = false;
    const t0 = performance.now();
    const r = await fetch("/frame?t=" + Date.now());
    if (r.ok) {
      const blob = await r.blob();
      const url = URL.createObjectURL(blob);
      img.onload = () => URL.revokeObjectURL(url);
      img.src = url;
      setStatus("frame: " + (performance.now() - t0).toFixed(0) + " ms");
    } else {
      const e = await r.json().catch(() => ({error:"render failed"}));
      setStatus("render error: " + e.error);
    }
  }
  busy = false;
}

img.addEventListener("pointerdown", ev => {
  if (ev.shiftKey || pickMode) { startPickDrag(ev); return; }
  img.setPointerCapture(ev.pointerId);
  img.style.cursor = "grabbing";
  let lx = ev.clientX, ly = ev.clientY;
  const move = e => {
    pend.dtheta += -(e.clientX - lx) * 0.01;
    pend.dphi   +=  (e.clientY - ly) * 0.01;
    lx = e.clientX; ly = e.clientY;
    refreshFrame();
  };
  const up = () => {
    img.removeEventListener("pointermove", move);
    img.removeEventListener("pointerup", up);
    img.style.cursor = "grab";
  };
  img.addEventListener("pointermove", move);
  img.addEventListener("pointerup", up);
});
img.addEventListener("wheel", ev => {
  ev.preventDefault();
  if (pickMode || ev.shiftKey) {
    // Depth scrub: push the reference point along the last pick ray
    // (the reference's ctrl+wheel PointPicker interaction).
    pend.scrub += -ev.deltaY * 0.0007;
  } else {
    pend.zoom *= Math.pow(1.0015, ev.deltaY);
  }
  refreshFrame();
}, {passive:false});

async function doPick(ev) {
  const r = img.getBoundingClientRect();
  const px = Math.round((ev.clientX - r.left) / r.width *
                        info.image_size[0]);
  const py = Math.round((ev.clientY - r.top) / r.height *
                        info.image_size[1]);
  const reply = await api({op:"pick", px:px, py:py});
  if (reply.ok) {
    document.getElementById("refpt").textContent =
      reply.reference_point.join(", ");
    refreshFrame();
  } else setStatus(reply.error);
}

// Dragging the reference point re-runs the fused correlate+render
// program per frame (the reference's PointPicker drag interaction).
// One pick in flight; moves coalesce to the latest position.
function startPickDrag(ev) {
  img.setPointerCapture(ev.pointerId);
  let queued = null, picking = false;
  const pickAt = async e => {
    if (picking) { queued = e; return; }
    picking = true;
    await doPick(e);
    picking = false;
    if (queued) { const q = queued; queued = null; pickAt(q); }
  };
  pickAt(ev);
  const move = e => pickAt(e);
  const up = () => {
    img.removeEventListener("pointermove", move);
    img.removeEventListener("pointerup", up);
  };
  img.addEventListener("pointermove", move);
  img.addEventListener("pointerup", up);
}

// -- TF opacity-curve editor (the reference TF widget analogue) ------
// Model: sorted [pos, alpha] pairs in [0,1]². Drag moves a point
// (endpoints move vertically only), dblclick adds, contextmenu
// removes (endpoints stay). Edits debounce into one set_tf call.
function initTfEditor(points) {
  const cv = document.getElementById("tfcanvas");
  const ctx = cv.getContext("2d");
  let pts = (points || [[0, 0], [1, 0.8]]).map(p => [p[0], p[1]]);
  let dragIdx = -1, sendTimer = null;
  const PAD = 6;
  const toX = p => PAD + p * (cv.width - 2 * PAD);
  const toY = a => cv.height - PAD - a * (cv.height - 2 * PAD);
  const fromX = x => Math.min(1, Math.max(0,
    (x - PAD) / (cv.width - 2 * PAD)));
  const fromY = y => Math.min(1, Math.max(0,
    (cv.height - PAD - y) / (cv.height - 2 * PAD)));
  function draw() {
    ctx.clearRect(0, 0, cv.width, cv.height);
    ctx.strokeStyle = "#6ea8ff"; ctx.lineWidth = 1.5;
    ctx.beginPath();
    pts.forEach((p, i) => i ? ctx.lineTo(toX(p[0]), toY(p[1]))
                            : ctx.moveTo(toX(p[0]), toY(p[1])));
    ctx.stroke();
    ctx.fillStyle = "#fff";
    for (const p of pts) {
      ctx.beginPath();
      ctx.arc(toX(p[0]), toY(p[1]), 3.5, 0, 7);
      ctx.fill();
    }
  }
  function send() {
    clearTimeout(sendTimer);
    sendTimer = setTimeout(async () => {
      await api({op:"set_tf", opacity_points:pts});
      refreshFrame();
    }, 150);
  }
  function hit(ev) {
    const r = cv.getBoundingClientRect();
    const x = ev.clientX - r.left, y = ev.clientY - r.top;
    let best = -1, bd = 10;
    pts.forEach((p, i) => {
      const d = Math.hypot(toX(p[0]) - x, toY(p[1]) - y);
      if (d < bd) { bd = d; best = i; }
    });
    return best;
  }
  cv.addEventListener("pointerdown", ev => {
    dragIdx = hit(ev);
    if (dragIdx >= 0) cv.setPointerCapture(ev.pointerId);
  });
  cv.addEventListener("pointermove", ev => {
    if (dragIdx < 0) return;
    const r = cv.getBoundingClientRect();
    const a = fromY(ev.clientY - r.top);
    let x = fromX(ev.clientX - r.left);
    if (dragIdx === 0) x = 0;
    else if (dragIdx === pts.length - 1) x = 1;
    else x = Math.min(pts[dragIdx + 1][0],
                      Math.max(pts[dragIdx - 1][0], x));
    pts[dragIdx] = [x, a];
    draw(); send();
  });
  cv.addEventListener("pointerup", () => { dragIdx = -1; });
  cv.addEventListener("dblclick", ev => {
    const r = cv.getBoundingClientRect();
    const x = fromX(ev.clientX - r.left), a = fromY(ev.clientY - r.top);
    let i = pts.findIndex(p => p[0] > x);
    if (i < 0) i = pts.length - 1;
    pts.splice(i, 0, [x, a]);
    draw(); send();
  });
  cv.addEventListener("contextmenu", ev => {
    ev.preventDefault();
    const i = hit(ev);
    if (i > 0 && i < pts.length - 1) { pts.splice(i, 1); draw(); send(); }
  });
  document.getElementById("tfreset").onclick = async () => {
    await api({op:"set_tf", opacity_points:null});
    const i2 = await api({op:"info"});
    pts = (i2.opacity_points || [[0, 0], [1, 0.8]])
      .map(p => [p[0], p[1]]);
    draw(); refreshFrame();
  };
  draw();
}

// Color control points: markers on a gradient strip. Click a marker →
// color picker; shift+click adds a point at that position;
// right-click removes. null → the named colormap drives colors.
function initTfColors(points) {
  const cv = document.getElementById("tfcolors");
  const ctx = cv.getContext("2d");
  const picker = document.getElementById("tfcolorpick");
  let cpts = points ? points.map(p => [p[0], p[1].slice()]) : null;
  let editIdx = -1;
  const PAD = 6;
  const toX = p => PAD + p * (cv.width - 2 * PAD);
  const fromX = x => Math.min(1, Math.max(0,
    (x - PAD) / (cv.width - 2 * PAD)));
  const hex = c => "#" + c.map(v =>
    Math.round(v * 255).toString(16).padStart(2, "0")).join("");
  function draw() {
    ctx.clearRect(0, 0, cv.width, cv.height);
    if (!cpts) {
      ctx.fillStyle = "#888"; ctx.font = "10px sans-serif";
      ctx.fillText("colors: colormap (shift+click to customize)",
                   8, 12);
      return;
    }
    const g = ctx.createLinearGradient(PAD, 0, cv.width - PAD, 0);
    for (const p of cpts) g.addColorStop(p[0], hex(p[1]));
    ctx.fillStyle = g;
    ctx.fillRect(PAD, 2, cv.width - 2 * PAD, cv.height - 4);
    for (const p of cpts) {
      ctx.beginPath();
      ctx.arc(toX(p[0]), cv.height / 2, 4, 0, 7);
      ctx.fillStyle = hex(p[1]); ctx.fill();
      ctx.strokeStyle = "#fff"; ctx.lineWidth = 1.2; ctx.stroke();
    }
  }
  async function send() {
    await api({op:"set_tf", color_points:cpts});
    refreshFrame();
  }
  function hit(ev) {
    if (!cpts) return -1;
    const r = cv.getBoundingClientRect();
    const x = ev.clientX - r.left;
    let best = -1, bd = 8;
    cpts.forEach((p, i) => {
      const d = Math.abs(toX(p[0]) - x);
      if (d < bd) { bd = d; best = i; }
    });
    return best;
  }
  cv.addEventListener("click", async ev => {
    const r = cv.getBoundingClientRect();
    if (ev.shiftKey) {
      const x = fromX(ev.clientX - r.left);
      if (!cpts) {
        // Materialize an editable two-point ramp to start from.
        cpts = [[0, [0, 0, 1]], [1, [1, 0, 0]]];
      }
      let i = cpts.findIndex(p => p[0] > x);
      if (i < 0) i = cpts.length;
      cpts.splice(i, 0, [x, [0.5, 0.5, 0.5]]);
      draw(); send();
      return;
    }
    editIdx = hit(ev);
    if (editIdx < 0) return;
    picker.value = hex(cpts[editIdx][1]);
    picker.onchange = () => {
      const v = picker.value;
      cpts[editIdx][1] = [1, 3, 5].map(k =>
        parseInt(v.slice(k, k + 2), 16) / 255);
      draw(); send();
    };
    picker.click();
  });
  cv.addEventListener("contextmenu", ev => {
    ev.preventDefault();
    const i = hit(ev);
    if (cpts && i >= 0 && cpts.length > 2) {
      cpts.splice(i, 1); draw(); send();
    } else if (cpts && i < 0) {
      cpts = null; draw(); send();   // back to the colormap
    }
  });
  document.getElementById("tfsave").onclick = async () => {
    const r = await api({op:"tf_save"});
    if (!r.ok) return;
    const blob = new Blob([r.xml], {type: "application/xml"});
    const a = document.createElement("a");
    a.href = URL.createObjectURL(blob);
    a.download = "transfer_function.xml";
    a.click();
  };
  const fileInput = document.getElementById("tfload");
  document.getElementById("tfloadbtn").onclick = () =>
    fileInput.click();
  fileInput.onchange = async () => {
    const file = fileInput.files[0];
    if (!file) return;
    const xml = await file.text();
    const r = await api({op:"tf_load", xml:xml});
    if (r.ok === false) { alert(r.error); return; }
    const i2 = await api({op:"info"});
    cpts = i2.color_points
      ? i2.color_points.map(p => [p[0], p[1].slice()]) : null;
    draw(); refreshFrame();
  };
  draw();
}

function fillSelect(id, values, current) {
  const s = document.getElementById(id);
  s.innerHTML = "";
  for (const v of values) {
    const o = document.createElement("option");
    o.value = v; o.textContent = v;
    if (v === current) o.selected = true;
    s.appendChild(o);
  }
}

async function init() {
  info = await api({op:"info"});
  if (info.num_views > 1) {
    document.getElementById("viewrow").style.display = "";
    fillSelect("viewsel",
      Array.from({length: info.num_views}, (_, i) => String(i)),
      String(info.view));
    document.getElementById("viewsel").onchange = async ev => {
      await api({op:"set_view", view:+ev.target.value}); refreshFrame();
    };
  }
  fillSelect("measure", info.measures, info.measure);
  // Derived (calculator) outputs are not valid calculator INPUTS —
  // the server rejects them; keep them out of the dropdown.
  fillSelect("field",
    info.fields.filter(f => !(info.derived_fields || []).includes(f)),
    null);
  fillSelect("colormap", info.colormaps, info.colormap);
  fillSelect("ckload", [""].concat(info.checkpoints), "");
  const t = document.getElementById("time"),
        e = document.getElementById("member");
  t.max = info.grid.ts - 1; e.max = info.grid.es - 1;
  t.value = info.time; e.value = info.member;
  document.getElementById("tval").textContent = info.time;
  document.getElementById("eval").textContent = info.member;
  if (info.reference_point)
    document.getElementById("refpt").textContent =
      info.reference_point.join(", ");
  document.getElementById("measure").onchange = async ev => {
    await api({op:"set_measure", measure:ev.target.value}); refreshFrame();
  };
  document.getElementById("field").onchange = async ev => {
    await api({op:"set_field", field:ev.target.value}); refreshFrame();
  };
  document.getElementById("colormap").onchange = async ev => {
    await api({op:"set_colormap", colormap:ev.target.value}); refreshFrame();
  };
  t.oninput = async ev => {
    document.getElementById("tval").textContent = ev.target.value;
    await api({op:"set_time", time:+ev.target.value}); refreshFrame();
  };
  e.oninput = async ev => {
    document.getElementById("eval").textContent = ev.target.value;
    await api({op:"set_member", member:+ev.target.value}); refreshFrame();
  };
  const vr = (info.renderers || []).find(
    r => ["dvr", "iso_ray", "iso_raster", "slice"].includes(r.type));
  const rsel = document.getElementById("renderer");
  if (vr) {
    rsel.value = vr.type;
    if (vr.attenuation !== undefined)
      document.getElementById("atten").value = vr.attenuation;
    if (vr.iso_value !== undefined)
      document.getElementById("isoval").value = vr.iso_value;
    if (vr.axis) document.getElementById("saxis").value = vr.axis;
    if (vr.position !== undefined)
      document.getElementById("spos").value = vr.position * 100;
  }
  function showRendererRows() {
    const k = rsel.value;
    document.getElementById("dvrrow").style.display =
      k === "dvr" ? "" : "none";
    document.getElementById("isorow").style.display =
      (k === "iso_ray" || k === "iso_raster") ? "" : "none";
    document.getElementById("slicerow").style.display =
      k === "slice" ? "" : "none";
  }
  showRendererRows();
  rsel.onchange = async ev => {
    await api({op:"set_renderer", renderer:ev.target.value});
    showRendererRows(); refreshFrame();
  };
  document.getElementById("atten").oninput = async ev => {
    document.getElementById("attval").textContent = ev.target.value;
    await api({op:"set_renderer_option", key:"attenuation",
               value:+ev.target.value});
    refreshFrame();
  };
  document.getElementById("isoval").onchange = async ev => {
    const v = parseFloat(ev.target.value);
    if (!isFinite(v)) { setStatus("iso value must be a number"); return; }
    await api({op:"set_renderer_option", key:"iso_value", value:v});
    refreshFrame();
  };
  document.getElementById("saxis").onchange = async ev => {
    await api({op:"set_renderer_option", key:"axis",
               value:ev.target.value});
    refreshFrame();
  };
  document.getElementById("spos").oninput = async ev => {
    document.getElementById("sposval").textContent =
      (ev.target.value / 100).toFixed(2);
    await api({op:"set_renderer_option", key:"position",
               value:ev.target.value / 100});
    refreshFrame();
  };
  let hebContext = false;
  function loadDiagram(kind) {
    setStatus("computing " + kind + " diagram…");
    const dock = document.getElementById("diagdock");
    const di = document.getElementById("diagimg");
    const extra = (kind === "heb" && hebContext) ? "&context=1" : "";
    di.src = "/diagram?kind=" + kind + extra + "&t=" + Date.now();
    di.onload = () => { dock.style.display = ""; setStatus("");
                        di.onerror = null; };
    di.onerror = () => setStatus("diagram failed — see server log");
  }
  document.getElementById("hebctx").onclick = ev => {
    hebContext = !hebContext;
    ev.target.classList.toggle("off", !hebContext);
    loadDiagram("heb");
  };
  // HEB drill-down (reference DiagramRenderer stack): click a chord
  // row to focus its region pair (outlined orange/cyan in the 3D
  // view), back to pop a level.
  async function refreshHebUi() {
    const ui = document.getElementById("hebui");
    setStatus("sampling HEB chords…");
    const r = await api({op:"heb_chords"});
    setStatus("");
    if (!r.ok) { setStatus("HEB: " + r.error); return; }
    document.getElementById("hebdepth").textContent =
      "level " + (r.depth - 1) + " · " + r.chords.length + " chords";
    const list = document.getElementById("hebchords");
    list.innerHTML = "";
    r.chords.forEach(c => {
      const row = document.createElement("div");
      row.textContent = c.value + "  " + c.a + " ↔ " + c.b;
      row.style.cursor = "pointer";
      row.onmouseenter = () => row.style.background = "#2a2e37";
      row.onmouseleave = () => row.style.background = "";
      row.onclick = async () => {
        setStatus("drilling into chord " + c.index + "…");
        const d = await api({op:"heb_drill", chord:c.index});
        if (!d.ok) { setStatus("HEB: " + d.error); return; }
        await refreshHebUi(); loadDiagram("heb"); refreshFrame();
      };
      list.appendChild(row);
    });
    ui.style.display = "";
  }
  document.getElementById("hebback").onclick = async () => {
    const d = await api({op:"heb_pop"});
    if (!d.ok) { setStatus("HEB: " + d.error); return; }
    await refreshHebUi(); loadDiagram("heb"); refreshFrame();
  };
  document.getElementById("diagram").onchange = async ev => {
    const kind = ev.target.value;
    const dock = document.getElementById("diagdock");
    const hebui = document.getElementById("hebui");
    if (kind !== "heb" && hebui.style.display !== "none") {
      hebui.style.display = "none";
      await api({op:"heb_reset"}); refreshFrame();
    }
    if (!kind) { dock.style.display = "none"; return; }
    if (kind === "timeseries" && info.grid.ts < 2) {
      setStatus("timeseries needs a multi-timestep dataset");
      ev.target.value = "";
      return;
    }
    loadDiagram(kind);
    if (kind === "heb") refreshHebUi();
  };
  const absbtn = document.getElementById("absbtn");
  absbtn.classList.toggle("off", !info.absolute);
  absbtn.onclick = async ev => {
    const on = ev.target.classList.toggle("off");
    await api({op:"set_absolute", value:!on});
    refreshFrame();
  };
  initTfEditor(info.opacity_points);
  initTfColors(info.color_points);
  document.getElementById("pick").onclick = ev => {
    pickMode = !pickMode;
    ev.target.classList.toggle("off", !pickMode);
    img.style.cursor = pickMode ? "crosshair" : "grab";
  };
  document.getElementById("legend").onclick = async ev => {
    const on = ev.target.classList.toggle("off");
    await api({op:"set_option", key:"legend", value:!on}); refreshFrame();
  };
  document.getElementById("cksave").onclick = async () => {
    const name = document.getElementById("ckname").value || "default";
    await api({op:"checkpoint_save", name:name});
    const i2 = await api({op:"info"});
    fillSelect("ckload", [""].concat(i2.checkpoints), "");
  };
  document.getElementById("ckload").onchange = async ev => {
    if (!ev.target.value) return;
    await api({op:"checkpoint_restore", name:ev.target.value});
    refreshFrame();
  };
  refreshFrame();
}
init();
</script></body></html>
"""
