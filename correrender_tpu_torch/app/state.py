"""Headless scenes and JSON app-state files.

Counterpart of ``correrender_tpu/app/state.py``: a ``Scene`` holds a
:class:`~correrender_tpu_torch.core.fields.VolumeData`, its calculators,
renderer settings and per-view cameras, and composites a view's
renderers into one frame on the volume's device. The state-file schema
is the JAX package's own (``save_state`` writes the same document):

```json
{
  "version": 1,
  "dataset": {"filename": ..., or "catalog": ..., "name": ...},
  "views": [{"camera": {"position": [..], "look_at": [..], "fovy": ..}}],
  "calculators": [{"type": "<CALCULATOR_TYPE_IDS>", ...settings}],
  "renderers": [{"type": "<RENDERING_MODE_NAMES_ID>", "view": 0,
                 ...settings}]
}
```

Renderers: ``dvr`` (shear-warp, its restricted and depth-clipped forms,
and the exact marcher), ``iso_ray`` (the shear-warp first hit of
``render/iso_fast.py``, or the exact marcher), ``iso_raster``, ``slice``
(axis-aligned or oblique), ``domain_outline`` and ``world_map``; the
reference-point markers and the colour legend. Slices, outlines and
isosurfaces z-merge by eye distance, and DVR stops at the merged depth.
The diagram family (``diagram``, ``scatter_plot``, ``correlation_matrix``,
``time_series_correlation``, ``distribution_similarity``) renders to SVG
(:meth:`Scene.render_diagram`), computed on the volume's device, and is
rasterized and composited over the frame as an overlay; ``render_dock``
tiles the views. State files load and save in the framework's schema or
in the reference app's (``app/state_ref.py``).
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from correrender_tpu_torch.app.state_ref import (
    convert_reference_state,
    is_reference_state,
    reference_state_from_scene,
)
from correrender_tpu_torch.calculators.base import calculator_from_settings
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.render.classify import classify_volume
from correrender_tpu_torch.render.dvr_fast import (
    dvr_shearwarp,
    prepare_shearwarp,
    shearwarp_camera_key,
    shearwarp_viable,
)
from correrender_tpu_torch.render.iso import iso_render
from correrender_tpu_torch.render.legend import (
    blend_legend,
    color_legend_overlay,
    legend_patch,
)
from correrender_tpu_torch.render.outline import outline_render
from correrender_tpu_torch.render.picking import (
    render_reference_point_marker,
)
from correrender_tpu_torch.render.iso_fast import (
    iso_shearwarp,
    prepare_iso_shearwarp,
)
from correrender_tpu_torch.render.raymarch_exact import (
    ExactPrepared,
    dvr_render_exact,
    iso_render_exact,
)
from correrender_tpu_torch.render.restriction import (
    apply_restriction_rgba,
    restriction_center,
    restriction_mask,
)
from correrender_tpu_torch.render.slice_renderer import slice_render_3d
from correrender_tpu_torch.render.tf import (
    TransferFunction,
    default_opacity_points,
)
from correrender_tpu_torch.render.worldmap import (
    graticule_texture,
    load_raster_texture,
    rasterize_shapefile,
    world_map_render,
)
from correrender_tpu_torch.utils.profiling import zone

#: Reference RenderingModes.hpp:62-73.
RENDERING_MODE_IDS = [
    "dvr",
    "iso_ray",
    "iso_raster",
    "domain_outline",
    "slice",
    "world_map",
    "diagram",
    "scatter_plot",
    "correlation_matrix",
    "time_series_correlation",
    "distribution_similarity",
]

#: The renderer types whose transfer function the legend shows.
_LEGEND_TYPES = ("dvr", "slice", "iso_ray")

#: Ground-plane textures kept on the device by a Scene.
_TEXTURE_CACHE_CAP = 4


def _camera_from_json(node: dict) -> Camera:
    kwargs = {}
    if "position" in node:
        kwargs["position"] = tuple(node["position"])
    if "look_at" in node:
        kwargs["look_at_point"] = tuple(node["look_at"])
    if "up" in node:
        kwargs["up"] = tuple(node["up"])
    if "fovy" in node:
        kwargs["fovy"] = float(node["fovy"])
    return Camera(**kwargs)


def _camera_to_json(cam: Camera) -> dict:
    return {
        "position": list(cam.position),
        "look_at": list(cam.look_at_point),
        "up": list(cam.up),
        "fovy": cam.fovy,
    }


def _restriction_signature(restriction):
    if restriction is None:
        return None
    center, radius, metric = restriction
    return (tuple(float(c) for c in center), radius, metric)


class Scene:
    """A VolumeData, its calculators, renderer settings and per-view
    cameras."""

    DIAGRAM_TYPES = ("diagram", "scatter_plot", "correlation_matrix",
                     "time_series_correlation", "distribution_similarity")

    #: Resident layouts kept by :meth:`render_view` (an LRU): one entry
    #: thrashes with two fast renderers or two views.
    _PREPARED_CACHE_CAP = 8

    def __init__(self, volume_data, views=None):
        self.volume_data = volume_data
        self.views = views or [Camera()]
        self.renderers: list[dict] = []
        self.transfer_functions: dict[str, TransferFunction] = {}
        self.dataset_info: Optional[dict] = None
        self.current_time = 0
        self.current_member = 0
        # Rows of view indices (the reference persists its dock layout,
        # MainAppState.cpp:131); kept for the state file.
        self.dock_layout: list[list[int]] = [list(range(len(self.views)))]
        # Named camera bookmarks (MainApp.cpp:2045): name → Camera.
        self.camera_checkpoints: dict[str, Camera] = {}
        # Resident layouts: shear-warp DVR and iso slices, exact-marcher
        # layouts. Keys hold the field's dirty epoch and the TF's uid.
        self._prepared_cache: OrderedDict = OrderedDict()
        # The reference app's window size, from an imported state file.
        self.window_size = None
        # Ground-plane textures on the device, keyed on their source (and
        # a file's modification time), and the legend's patch, keyed on
        # the frame size and the TF's uid: the JAX Scene builds both anew
        # each frame, with the same pixels.
        self._textures: dict = {}
        self._legend = (None, None)
        # Rasterized diagram overlays on the device, an LRU keyed as the
        # JAX Scene keys it: (node signature, target px, time, member,
        # dirty epoch) → RGBA tensor, or False for a diagram that failed.
        self._overlay_cache: OrderedDict = OrderedDict()

    # -- construction ------------------------------------------------------

    def add_calculator(self, calculator):
        self.volume_data.add_calculator(calculator)
        return calculator.output_name

    def add_renderer(self, type_id: str, view: int = 0, **settings):
        if type_id not in RENDERING_MODE_IDS:
            raise ValueError(f"unknown renderer type {type_id!r}; known: "
                             f"{RENDERING_MODE_IDS}")
        self.renderers.append({"type": type_id, "view": view, **settings})

    def save_camera_checkpoint(self, name: str, view: int = 0):
        """Bookmark the view's current camera under ``name``."""
        self.camera_checkpoints[name] = self.views[view]

    def restore_camera_checkpoint(self, name: str, view: int = 0):
        """Restore a bookmarked camera into ``view``."""
        if name not in self.camera_checkpoints:
            raise KeyError(f"no camera checkpoint {name!r}; saved: "
                           f"{sorted(self.camera_checkpoints)}")
        self.views[view] = self.camera_checkpoints[name]

    def tf_for(self, field_name: str) -> TransferFunction:
        """The field's transfer function; by default coolwarm over the
        field's range at the current time and member."""
        if field_name not in self.transfer_functions:
            lo, hi = self.volume_data.get_min_max(
                field_name, self.current_time, self.current_member)
            self.transfer_functions[field_name] = (
                TransferFunction.from_colormap(
                    "coolwarm", domain=(lo, hi),
                    opacity_points=default_opacity_points(lo, hi),
                    device=self.volume_data.device))
        return self.transfer_functions[field_name]

    def _prep_cache_get(self, key):
        prep = self._prepared_cache.get(key)
        if prep is not None:
            self._prepared_cache.move_to_end(key)
        return prep

    def _prep_cache_put(self, key, prep):
        self._prepared_cache[key] = prep
        self._prepared_cache.move_to_end(key)
        while len(self._prepared_cache) > self._PREPARED_CACHE_CAP:
            self._prepared_cache.popitem(last=False)

    def _exact_prepared(self, vol, field):
        """The exact marchers' resident layouts of a field's slab
        (``render/raymarch_exact.py::ExactPrepared``), in the LRU. Keyed
        on the slab alone: the restriction is not part of the layout."""
        key = ("exact_march", field, self.current_time, self.current_member,
               self.volume_data.dirty_epoch(field))
        prep = self._prep_cache_get(key)
        if prep is None:
            prep = ExactPrepared(vol)
            self._prep_cache_put(key, prep)
        return prep

    # -- rendering ---------------------------------------------------------

    def _active_render_restriction(self, box):
        """(center, radius, metric) of the last calculator with an active
        render restriction, else None: the last to set it wins
        (VolumeData.hpp:424-430)."""
        for calc in reversed(self.volume_data.calculators.values()):
            if getattr(calc, "use_render_restriction", False):
                center = restriction_center(calc.reference_point,
                                            self.volume_data.grid.shape_zyx,
                                            box)
                return (center, float(calc.render_restriction_radius),
                        str(calc.render_restriction_metric))
        return None

    @staticmethod
    def _restrict_iso_volume(vol, box, restriction):
        """NaN outside the restriction ball: both iso marchers take a NaN
        sample as no crossing, so surfaces stop at the ball."""
        if restriction is None:
            return vol
        center, radius, metric = restriction
        mask = restriction_mask(vol.shape, box, center, radius, metric,
                                device=vol.device)
        return torch.where(mask > 0, vol, torch.nan)

    def _render_iso(self, r, field, cam, box, restriction, image_size,
                    fast_dvr):
        """One ``iso_ray`` renderer: (rgba, depth)."""
        vd = self.volume_data
        raw_vol = vd.get_field(field, self.current_time, self.current_member)
        vol = self._restrict_iso_volume(raw_vol, box, restriction)
        closed = bool(r.get("closed_surface", False))
        color = r.get("color", (0.9, 0.4, 0.2, 1.0))
        iso_value = r.get("iso_value", 0.5)
        mode = r.get("intersection_mode", "bisection")
        # A restricted slab is NaN outside the ball. The fast renderer's
        # tent products spread a NaN over its whole slab row (0 · NaN is
        # NaN) and find no crossing at all, so a restricted frame takes the
        # exact marcher, which reads a NaN sample as no crossing (the JAX
        # Scene draws an empty frame here: ROADMAP C).
        if (fast_dvr and restriction is None and vd.model_matrix is None
                and not closed and r.get("quality") != "exact"
                and mode == "bisection" and shearwarp_viable(cam, box)):
            # Default 2× axial supersampling, paid once in the layout.
            ss = int(r.get("axial_supersample", 2))
            pkey = ("iso", field, self.current_time, self.current_member,
                    vd.dirty_epoch(field), shearwarp_camera_key(cam), ss)
            prep = self._prep_cache_get(pkey)
            if prep is None:
                prep = prepare_iso_shearwarp(vol, cam, box=box,
                                             axial_supersample=ss)
                self._prep_cache_put(pkey, prep)
            return iso_shearwarp(vol, cam, iso_value, surface_color=color,
                                 image_size=image_size, box=box,
                                 background=(0, 0, 0, 0), prepared=prep,
                                 axial_supersample=ss, return_depth=True)
        # A restricted slab is NaN outside the ball, so its layout is
        # built for the frame and not cached; the LRU holds the layouts
        # of field slabs only, shared with the exact DVR renderer.
        prepared = (self._exact_prepared(vol, field) if restriction is None
                    else None)
        return iso_render_exact(vol, cam, iso_value, surface_color=color,
                                image_size=image_size, box=box,
                                background=(0, 0, 0, 0),
                                model_matrix=vd.model_matrix,
                                closed_surface=closed,
                                intersection_mode=mode, return_depth=True,
                                prepared=prepared)

    def _render_dvr(self, r, field, cam, box, restriction, image_size,
                    fast_dvr, scene_depth):
        """One ``dvr`` renderer, clipped against the opaque depth."""
        vd = self.volume_data
        vol = vd.get_field(field, self.current_time, self.current_member)
        with zone("render.dvr"):
            tf = self.tf_for(field)
            kwargs = dict(image_size=image_size, box=box,
                          attenuation=r.get("attenuation", 100.0),
                          background=(0, 0, 0, 0))
            step_size = float(r.get("step_size", 0.1))
            nan_mode = r.get("nan_mode", "ignore")
            # Shear-warp composites one slice a voxel plane; other step
            # sizes, NaN modes, model matrices, "exact" quality and
            # eye-inside cameras take the exact marcher, which carries the
            # restriction.
            use_fast = (fast_dvr and vd.model_matrix is None
                        and nan_mode == "ignore" and step_size == 0.1
                        and r.get("quality") != "exact"
                        and shearwarp_viable(cam, box))
            if not use_fast:
                with zone("dvr.exact"):
                    return dvr_render_exact(
                        vol, cam, tf, restriction=restriction,
                        model_matrix=vd.model_matrix, nan_mode=nan_mode,
                        voxel_step=step_size, depth_limit=scene_depth,
                        prepared=self._exact_prepared(vol, field),
                        **kwargs)
            # The field's slab (with its dirty epoch) and the TF's uid key
            # the layout. The JAX package also reuses a transposed copy of
            # the field across TF changes; here K2 reads the field through
            # strided views, so there is nothing to reuse.
            pkey = ((field, self.current_time, self.current_member,
                     vd.dirty_epoch(field)), tf.uid,
                    shearwarp_camera_key(cam),
                    _restriction_signature(restriction))
            prep = self._prep_cache_get(pkey)
            if prep is None:
                with zone("render.layout"):
                    classified = None
                    if restriction is not None:
                        center, radius, metric = restriction
                        classified = apply_restriction_rgba(
                            classify_volume(vol, tf.lut, tf.domain),
                            restriction_mask(vol.shape, box, center, radius,
                                             metric, device=vol.device))
                    prep = prepare_shearwarp(vol, tf, cam,
                                             classified=classified)
                self._prep_cache_put(pkey, prep)
            return dvr_shearwarp(vol, cam, tf, prepared=prep,
                                 depth_limit=scene_depth, **kwargs)

    def _render_slice(self, r, field, cam, box, image_size):
        """One ``slice`` renderer: (rgba, depth). An oblique plane comes
        in the reference's keys ``normal_x/y/z`` + ``plane_dist``
        (SliceRenderer.cpp:360-368); ``axis`` + ``position`` is the
        compact axis-aligned form."""
        normal = r.get("normal")
        if normal is None and "normal_x" in r:
            normal = (r["normal_x"], r.get("normal_y", 0.0),
                      r.get("normal_z", 0.0))
        return slice_render_3d(
            self.volume_data.get_field(field, self.current_time,
                                       self.current_member),
            cam, self.tf_for(field), axis=r.get("axis", "z"),
            position=r.get("position", 0.5), normal=normal,
            plane_dist=r.get("plane_dist"),
            lighting_factor=r.get("lighting_factor", 0.0),
            nan_handling=r.get("nan_handling", "ignore"),
            fix_on_ground=bool(r.get("fix_on_ground", False)),
            image_size=image_size, box=box, background=(0, 0, 0, 0),
            return_depth=True)

    def _world_texture(self, r) -> torch.Tensor:
        """A ``world_map`` renderer's texture on the device: a local
        raster (WorldMapRenderer.cpp:57-91, without the download), a
        rasterized shapefile, or the graticule; built once per source
        and file version."""
        if r.get("raster"):
            lat = tuple(r.get("lat_range", (-90, 90)))
            lon = tuple(r.get("lon_range", (-180, 180)))
            key = ("raster", r["raster"], os.stat(r["raster"]).st_mtime_ns,
                   lat, lon)
        elif r.get("shapefile"):
            key = ("shapefile", r["shapefile"],
                   os.stat(r["shapefile"]).st_mtime_ns)
        else:
            key = ("graticule",)
        tex = self._textures.get(key)
        if tex is None:
            if key[0] == "raster":
                host = load_raster_texture(key[1], lat_range=lat,
                                           lon_range=lon)
            elif key[0] == "shapefile":
                host = rasterize_shapefile(key[1])
            else:
                host = graticule_texture()
            if len(self._textures) >= _TEXTURE_CACHE_CAP:
                self._textures.clear()
            tex = self._textures[key] = torch.as_tensor(
                host, device=self.volume_data.device)
        return tex

    def _draw_legend(self, image, view, image_size):
        """The legend of the view's first ``dvr``, ``slice`` or
        ``iso_ray`` renderer's TF (the reference's colour-legend widget),
        its patch rasterized on the host once per frame size and TF and
        blended on the device."""
        r = next((r for r in self.renderers
                  if r["view"] == view and not r.get("hidden")
                  and r["type"] in _LEGEND_TYPES), None)
        if r is None:
            return image
        tf = self.tf_for(r.get("field", self.volume_data.field_names[0]))
        key = (tuple(image_size), tf.uid)
        if self._legend[0] != key:
            self._legend = (key, legend_patch(image_size, tf))
        patch = self._legend[1]
        if patch is None:  # a frame too small for the legend: the host path
            return torch.as_tensor(
                color_legend_overlay(image.cpu().numpy(), tf),
                device=image.device)
        return blend_legend(image, patch)

    def render_view(self, view: int = 0, image_size=(512, 512),
                    fast_dvr: bool = True, show_reference_points=False,
                    show_legend: bool = False,
                    show_diagram_overlays: bool = True) -> torch.Tensor:
        """Composite the view's renderers over a transparent base with a
        shared depth buffer (the reference's SceneData.hpp): world maps
        underlay the frame, opaque renderers (isosurfaces, slices,
        outlines) z-merge by eye distance, then DVR clips against the
        merged depth; the reference-point markers, the legend and the
        diagram overlays go on top. Returns ``(H, W, 4)`` straight-alpha
        RGBA on the volume's device."""
        with zone("scene.render_view"):
            cam = self.views[view]
            vd = self.volume_data
            box = vd.grid.render_box()
            restriction = self._active_render_restriction(box)
            image = None
            opaque = []
            dvr_jobs = []
            for r in self.renderers:
                if (r["view"] != view or r.get("hidden")
                        or r["type"] in self.DIAGRAM_TYPES):
                    continue
                field = r.get("field", vd.field_names[0])
                if r["type"] == "dvr":
                    dvr_jobs.append((r, field))
                elif r["type"] == "iso_ray":
                    opaque.append(self._render_iso(r, field, cam, box,
                                                   restriction, image_size,
                                                   fast_dvr))
                elif r["type"] == "iso_raster":
                    vol = self._restrict_iso_volume(
                        vd.get_field(field, self.current_time,
                                     self.current_member), box, restriction)
                    opaque.append(iso_render(
                        vol, cam, r.get("iso_value", 0.5),
                        image_size=image_size, box=box,
                        background=(0, 0, 0, 0),
                        model_matrix=vd.model_matrix, return_depth=True))
                elif r["type"] == "slice":
                    opaque.append(self._render_slice(r, field, cam, box,
                                                     image_size))
                elif r["type"] == "domain_outline":
                    opaque.append(outline_render(
                        cam, box, image_size=image_size,
                        color=r.get("color", (1, 1, 1, 1)), return_depth=True,
                        device=vd.device))
                elif r["type"] == "world_map":
                    # The ground plane below the data: the farthest layer, a
                    # plain underlay outside the depth merge.
                    image = world_map_render(
                        cam, texture=self._world_texture(r),
                        plane_height=r.get("plane_height",
                                           float(box[0][1]) - 0.01),
                        image_size=image_size, box=box, base_image=image,
                        device=vd.device)

            merged, scene_depth = _depth_merge(opaque)
            if merged is not None:
                image = _composite(image, merged)
            for r, field in dvr_jobs:
                image = _composite(image, self._render_dvr(
                    r, field, cam, box, restriction, image_size, fast_dvr,
                    scene_depth))
            if image is None:
                image = torch.zeros(tuple(image_size[::-1]) + (4,),
                                    dtype=torch.float32, device=vd.device)
            if show_reference_points:
                # The reference's renderViewCalculator pass
                # (VolumeData.cpp:1948): one marker per calculator with a
                # reference point.
                for calc in vd.calculators.values():
                    point = getattr(calc, "reference_point", None)
                    if point is not None:
                        image = render_reference_point_marker(
                            cam, point, vd.grid.shape_zyx, box,
                            image_size=image_size, base_image=image)
            if show_legend:
                image = self._draw_legend(image, view, image_size)
            if show_diagram_overlays:
                image = self._composite_diagram_overlays(image, view,
                                                         image_size)
            return image

    #: Diagram overlays kept by :meth:`_composite_diagram_overlays`.
    _OVERLAY_CACHE_CAP = 16

    def _composite_diagram_overlays(self, image, view, image_size):
        """Composite the view's diagram-family nodes over the frame.

        The reference's diagram subsystem is an overlay renderer: charts
        draw into the 3D view and appear in screenshots and videos
        (DiagramRenderer.hpp:62-100). Each node's SVG is rasterized at
        ``overlay_frac`` of the frame's short side (once, then kept on
        the device in the LRU) and source-over composited at
        ``overlay_anchor`` (by default the corners in turn) on the
        frame's device. ``overlay: false`` keeps a node out of frames. A
        diagram that raises (e.g. a time-series node without a source)
        drops its overlay with a warning, as the JAX Scene does; its
        cache entry is ``False``.
        """
        nodes = [r for r in self.renderers
                 if r["view"] == view and not r.get("hidden")
                 and r["type"] in self.DIAGRAM_TYPES
                 and r.get("overlay", True)]
        if not nodes:
            return image
        from correrender_tpu_torch.diagrams.raster import (
            composite_overlay,
            rasterize_svg,
        )

        w, h = image_size
        anchors = ("bottom_right", "bottom_left", "top_right", "top_left")
        for i, node in enumerate(nodes):
            frac = float(node.get("overlay_frac", 0.42))
            target = max(64, int(min(w, h) * frac))
            field = node.get("field", self.volume_data.field_names[0])
            key = (repr(sorted(node.items(), key=lambda kv: kv[0])),
                   target, self.current_time, self.current_member,
                   self.volume_data.dirty_epoch(field))
            overlay = self._overlay_cache.get(key)
            if overlay is None:
                # Small overlays render from a smaller SVG canvas so
                # labels keep a readable size relative to the chart.
                svg_size = int(min(700, max(256, target * 2)))
                try:
                    svg = self.render_diagram(node, size=svg_size)
                except Exception as exc:
                    logging.getLogger(__name__).warning(
                        "diagram overlay %s skipped: %s", node["type"], exc)
                    overlay = False
                else:
                    overlay = torch.as_tensor(
                        rasterize_svg(svg, scale=target / svg_size),
                        device=image.device)
                self._overlay_cache[key] = overlay
                while len(self._overlay_cache) > self._OVERLAY_CACHE_CAP:
                    self._overlay_cache.popitem(last=False)
            else:
                self._overlay_cache.move_to_end(key)
            if overlay is False:
                continue
            image = composite_overlay(
                image, overlay,
                anchor=node.get("overlay_anchor", anchors[i % len(anchors)]),
                opacity=float(node.get("overlay_opacity", 1.0)))
        return image

    def render_dock(self, image_size=(1024, 768), fast_dvr: bool = True):
        """Composite every view into one canvas per the dock layout.

        ``dock_layout`` is a list of rows of view indices (persisted in
        state files); each row shares the canvas height equally and splits
        its width across its views — the headless analogue of the
        reference's docked DataView grid (src/Widgets/DataView,
        ViewManager). Returns ``(H, W, 4)`` on the volume's device.
        """
        width, height = image_size
        layout = self.dock_layout or [[i] for i in range(len(self.views))]
        canvas = torch.zeros((height, width, 4), dtype=torch.float32,
                             device=self.volume_data.device)
        row_h = height // len(layout)
        for r, row in enumerate(layout):
            if not row:
                continue
            col_w = width // len(row)
            for c, view_idx in enumerate(row):
                y0, x0 = r * row_h, c * col_w
                canvas[y0:y0 + row_h, x0:x0 + col_w] = self.render_view(
                    int(view_idx), image_size=(col_w, row_h),
                    fast_dvr=fast_dvr)
        return canvas

    # -- diagram-family renderers -----------------------------------------

    def render_diagram(self, node: dict, size: int = 700) -> str:
        """Render one diagram-family renderer node to SVG text.

        The reference draws these as view overlays (DiagramRenderer and
        friends); headlessly each node renders to its own vector graphic,
        honoring the node's settings — including everything a reference
        state file carries through ``load_state`` (measure, per-axis
        downscaling, sampling method, chord filters, ...). The member
        stack and the fields stay on the volume's device; the charts
        compute there.
        """
        vd = self.volume_data
        kind = node["type"]
        field = node.get("field", vd.field_names[0])
        time = self.current_time
        member = self.current_member
        if kind == "diagram":
            from correrender_tpu_torch.diagrams.heb import HEBChart

            factor = node.get("downsample_xyz", node.get("downsample", 4))
            measure_kw = {}
            if "mi_bins" in node:
                measure_kw["num_bins"] = int(node["mi_bins"])
            if "kmi_neighbors" in node:
                measure_kw["k"] = int(node["kmi_neighbors"])
            if "absolute" in node:
                measure_kw["absolute"] = bool(node["absolute"])
            chart = HEBChart(
                vd.get_member_stack(field, time),
                downsample_factor=factor,
                measure=node.get("measure", "pearson"),
                sampling_method=node.get("sampling_method", "mean"),
                num_samples=int(node.get("num_samples", 64)),
                max_chords=int(node.get("max_chords", 100)),
                octree_mode=node.get("octree_method", "topdown"),
                correlation_range=node.get("correlation_range"),
                cell_distance_range=node.get("cell_distance_range"),
                color_map=node.get("color_map", "coolwarm"),
                color_map_variance=node.get("color_map_variance",
                                            "viridis"),
                bayesian_screening=bool(node.get("bayesian_screening",
                                                 True)),
                **measure_kw,
            )
            chart.compute_correlations()
            if node.get("diagram_type") == "matrix":
                # The DiagramRenderer's alternative display mode
                # (CorrelationDefines.hpp:107-109).
                return chart.render_matrix_svg(size=size)
            return chart.render_svg(
                size=size,
                beta=float(node.get("beta", 0.75)),
                curve_thickness=float(node.get("curve_thickness", 1.0)),
                opacity_by_value=bool(node.get("opacity_by_value", True)),
                curve_opacity=float(node.get("curve_opacity_context", 0.8)),
                outer_ring_size_pct=float(node.get("outer_ring_size_pct",
                                                   0.06)),
            )
        if kind == "scatter_plot":
            from correrender_tpu_torch.diagrams.scatter import (
                render_scatter_svg,
            )

            field_b = node.get("field_b", field)
            return render_scatter_svg(
                vd.get_field(field, time, member).cpu().numpy(),
                vd.get_field(field_b, time, member).cpu().numpy(),
                labels=(field, field_b), size=size,
                point_radius=float(node.get("point_size", 2.0)),
                point_color=node.get("point_color"),
            )
        if kind == "correlation_matrix":
            from correrender_tpu_torch.diagrams.matrix import (
                field_correlation_matrix,
                render_matrix_svg,
            )

            m, names = field_correlation_matrix(
                vd, vd.field_names,
                measure=node.get("correlation_measure_type",
                                 node.get("measure", "pearson")),
            )
            return render_matrix_svg(
                m, labels=names, size=size,
                colormap=node.get("color_map", "coolwarm"))
        if kind == "distribution_similarity":
            from correrender_tpu_torch.diagrams.distribution_similarity \
                import distribution_similarity
            from correrender_tpu_torch.diagrams.scatter import (
                render_scatter_svg,
            )

            emb, labels, _ = distribution_similarity(
                vd.get_member_stack(field, time),
                mode=node.get("mode", "cell_member_values"),
                max_points=int(node.get("max_points", 400)),
                perplexity=float(node.get("perplexity", 30.0)),
                num_iters=int(node.get("tsne_num_iters", 500)),
                seed=int(node.get("tsne_seed", 0)),
                eps=(float(node["dbscan_eps"])
                     if node.get("dbscan_eps") else None),
                min_samples=int(node.get("dbscan_min_pts", 8)),
            )
            return render_scatter_svg(
                emb[:, 0], emb[:, 1], labels=("t-SNE 1", "t-SNE 2"),
                colors=labels, size=size,
            )
        if kind == "time_series_correlation":
            from correrender_tpu_torch.diagrams.octree import (
                downsample_fields,
            )
            from correrender_tpu_torch.diagrams.timeseries import (
                load_time_series,
                render_heatmap_svg,
                time_series_correlation,
            )

            window = node.get("window")
            if node.get("path"):
                series = torch.as_tensor(load_time_series(node["path"]),
                                         device=vd.device)
            else:
                # Region-mean series over the dataset's time axis (the
                # viewer dock's multi-timestep mode).
                g = vd.grid
                if g.ts < 2:
                    raise ValueError(
                        "time_series_correlation needs a time-series "
                        "file ('path') or a multi-timestep dataset")
                fvol = torch.stack([vd.get_field(field, t, member)
                                    for t in range(g.ts)], dim=-1)
                f = max(min(g.xs, g.ys) // 4, 1)
                series = downsample_fields(fvol, f).reshape(-1, g.ts)
                series = series[torch.isfinite(series).all(dim=1)]
            m = time_series_correlation(
                series, node.get("measure", "pearson"),
                window=int(window) if window else None)
            return render_heatmap_svg(
                m, size=size, colormap=node.get("color_map", "coolwarm"))
        raise ValueError(f"not a diagram-family renderer: {kind!r}")

    # -- state files -------------------------------------------------------

    def save_state(self, path: str, dataset: Optional[dict] = None,
                   reference_format: bool = False):
        """Write the scene as JSON in the framework's schema (the JAX
        package's document for the same scene), or with
        ``reference_format`` in the reference app's (MainAppState.cpp:
        106-205: sgl cameras, ``{type, state}`` nodes, TF-widget XML),
        which the reference app loads."""
        if reference_format:
            with open(path, "w") as f:
                json.dump(reference_state_from_scene(self, dataset=dataset),
                          f, indent=4)
            return
        doc = {
            "version": 1,
            "dataset": dataset or self.dataset_info or {},
            "views": [{"camera": _camera_to_json(c)} for c in self.views],
            "calculators": [
                {
                    "type": c.type_id,
                    **({"continuous_recompute": True}
                       if getattr(c, "continuous_recompute", False) else {}),
                    **_jsonable(c.get_settings()),
                }
                for c in self.volume_data.calculators.values()
            ],
            "renderers": _jsonable(self.renderers),
            "transfer_functions": {
                name: tf.to_dict()
                for name, tf in self.transfer_functions.items()
            },
            "current_time": self.current_time,
            "current_member": self.current_member,
            "dock_layout": self.dock_layout,
            "camera_checkpoints": {
                name: _camera_to_json(cam)
                for name, cam in self.camera_checkpoints.items()
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)

    @classmethod
    def load_state(cls, path: str, volume_data=None, device="cuda",
                   catalog: Optional[str] = None):
        """Load a state file of the framework's schema, or one saved by
        the reference app (detected and converted by
        ``app/state_ref.py``). Without ``volume_data`` the file's dataset
        (a filename, or a catalog entry: a reference file names its
        dataset by name, resolved in ``catalog``) is opened on
        ``device``."""
        from correrender_tpu_torch.io import load_catalog, load_volume
        from correrender_tpu_torch.io.catalog import open_dataset

        with open(path) as f:
            doc = json.load(f)
        if is_reference_state(doc):
            if volume_data is None:
                vol = doc.get("volume_data", {}) or {}
                if "filename" in vol:
                    volume_data = load_volume(vol["filename"], device=device)
                elif "name" in vol and catalog:
                    match = [e for e in load_catalog(catalog)
                             if e.name == vol["name"]]
                    if not match:
                        raise ValueError(f"dataset {vol['name']!r} not in "
                                         f"catalog {catalog!r}")
                    volume_data = open_dataset(match[0], device=device)
                else:
                    raise ValueError(
                        "reference state file names its dataset by "
                        "catalog entry; pass volume_data= or catalog=")
            doc, warnings = convert_reference_state(
                doc, volume_data.field_names)
            for message in warnings:
                logging.getLogger(__name__).warning("state import: %s",
                                                    message)
        if volume_data is None:
            ds = doc.get("dataset", {})
            if "catalog" in ds:
                entries = load_catalog(ds["catalog"])
                match = [e for e in entries if e.name == ds.get("name")]
                volume_data = open_dataset(match[0] if match else entries[0],
                                           device=device)
            elif "filename" in ds:
                volume_data = load_volume(ds["filename"], device=device)
            else:
                raise ValueError(
                    "state file has no dataset and none was provided")
        views = [_camera_from_json(v.get("camera", {}))
                 for v in doc.get("views", [{}])]
        scene = cls(volume_data, views)
        scene.dataset_info = doc.get("dataset")
        scene.current_time = doc.get("current_time", 0)
        scene.current_member = doc.get("current_member", 0)
        for node in doc.get("calculators", []):
            node = dict(node)
            type_id = node.pop("type")
            ref_extra = node.pop("_ref_extra", None)
            calc = calculator_from_settings(type_id, node)
            if ref_extra:
                # Reference-only settings, kept for a lossless re-export.
                calc._ref_extra = ref_extra
            scene.add_calculator(calc)
        for node in doc.get("renderers", []):
            node = dict(node)
            scene.add_renderer(node.pop("type"), **node)
        for name, tf_state in doc.get("transfer_functions", {}).items():
            scene.transfer_functions[name] = TransferFunction.from_dict(
                tf_state, device=volume_data.device)
        if "dock_layout" in doc:
            scene.dock_layout = [[int(i) for i in row]
                                 for row in doc["dock_layout"]]
        if "window_size" in doc:
            scene.window_size = tuple(int(v) for v in doc["window_size"])
        for name, node in doc.get("camera_checkpoints", {}).items():
            scene.camera_checkpoints[name] = _camera_from_json(node)
        return scene


def _composite(base, over):
    """Straight-alpha OVER of a new layer on top of the base image."""
    if base is None:
        return over
    a = over[..., 3:4]
    rgb = over[..., :3] * a + base[..., :3] * (1 - a)
    alpha = a[..., 0] + base[..., 3] * (1 - a[..., 0])
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def _depth_merge(layers):
    """Z-merge ``[(rgba, depth)]`` opaque layers per pixel: sorted by
    depth (stable), then folded back to front with premultiplied OVER,
    so the result does not depend on the layers' order. Depth is +inf
    where a layer is empty. Returns (rgba | None, depth | None)."""
    if not layers:
        return None, None
    if len(layers) == 1:
        return layers[0]
    rgba = torch.stack([im for im, _ in layers])  # (N, H, W, 4)
    depth = torch.stack([d for _, d in layers])  # (N, H, W)
    order = torch.argsort(depth, dim=0, stable=True)
    rgba = torch.take_along_dim(rgba, order[..., None], dim=0)
    a = rgba[-1][..., 3:4]
    rgbp = rgba[-1][..., :3] * a
    alpha = a[..., 0]
    for i in range(rgba.shape[0] - 2, -1, -1):  # toward the camera
        top = rgba[i]
        ta = top[..., 3:4]
        rgbp = top[..., :3] * ta + rgbp * (1 - ta)
        alpha = ta[..., 0] + alpha * (1 - ta[..., 0])
    rgb = rgbp / torch.clamp_min(alpha[..., None], 1e-9)
    return torch.cat([rgb, alpha[..., None]], dim=-1), depth.amin(dim=0)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj
