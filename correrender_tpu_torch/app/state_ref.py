"""Reference app-state JSON interchange.

A copy of ``correrender_tpu/app/state_ref.py`` (numpy and stdlib) with
its imports pointed at the port. It departs from the JAX module in one
way: a neural calculator type, which the port does not hold yet, raises
``NotImplementedError`` naming ROADMAP A.12
(``calculators.base.NOT_PORTED``) before anything is converted, since a
silently dropped calculator would render another scene. Types the JAX
package does not know either are skipped with a warning, and the
velocity family and ``dkl_calculator``, which JAX's converter has no
branch for, raise ``ValueError``, as there.

The reference persists full sessions as JSON (MainAppState.cpp:106-205
save / :212-423 load): ``global_camera`` + ``views`` (sgl cameras),
``volume_data`` (dataset + current indices + per-field transfer
functions as sgl TF-widget XML strings), ``calculators`` and
``renderers`` as ``{type, state}`` nodes whose ``state`` is a
``SettingsMap`` — a flat string→string map keyed by the names each
component reads in ``setSettings``.

This module converts that format to and from this framework's native
scene-state schema (app/state.py ``Scene.save_state``), so

* a state file saved by the reference app loads here unchanged
  (``Scene.load_state`` auto-detects the format), and
* ``Scene.save_state(..., reference_format=True)`` writes a file the
  reference app can load.

Field references: the reference stores scalar-field *indices* into the
live field list (dataset fields followed by calculator outputs in
creation order); this framework stores field *names*. The converter
resolves indices progressively — each converted calculator appends its
output name to the working list, mirroring how the reference's loader
grows the field list as it instantiates calculators.

Keys with no meaning here (Vulkan/CUDA device selection, buffer
tiling, ImGui window alignment) are preserved verbatim under a
``_ref_extra`` node key so a reference→native→reference round-trip is
lossless, and reported in the returned warnings list when they carry
user-visible semantics we do not replicate.
"""

from __future__ import annotations

import math

import numpy as np

from correrender_tpu_torch.calculators.base import (
    NOT_PORTED,
    calculator_from_settings,
    known_calculator_types,
)
from correrender_tpu_torch.calculators.set_predicate import COMPARISON_GLYPHS
from correrender_tpu_torch.diagrams import colormaps as _dcm
from correrender_tpu_torch.ops.registry import MEASURE_NAMES, measure_from_id
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.render.tf import (
    tf_from_xml_string,
    tf_to_xml_string,
)

# -- format detection ------------------------------------------------------

_REFERENCE_MARKERS = ("global_camera", "dock_data", "window_size",
                      "volume_data")


def is_reference_state(doc: dict) -> bool:
    """True when ``doc`` is a reference-app state file."""
    if any(k in doc for k in _REFERENCE_MARKERS):
        return True
    nodes = list(doc.get("renderers") or []) + list(
        doc.get("calculators") or [])
    return any(isinstance(n, dict) and isinstance(n.get("state"), dict)
               for n in nodes)


# -- SettingsMap value coercion --------------------------------------------
#
# SettingsMap serializes every value as a string ("0", "100", "pearson").


def _coerce(v):
    if not isinstance(v, str):
        return v
    s = v.strip()
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


#: Keys whose values are bitmask STRINGS ("0101" selects fields/views)
#: — numeric coercion would corrupt them ("01" is not the number 1).
_BITMASK_KEYS = frozenset({"view_visibility", "scalar_field_selection"})


def _coerce_map(state: dict) -> dict:
    return {k: (v if k in _BITMASK_KEYS else _coerce(v))
            for k, v in (state or {}).items()}


def _stringify(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    return str(v)


# -- cameras ---------------------------------------------------------------
#
# sgl cameras persist position + fovy + lookat and either legacy
# yaw/pitch or an orientation quaternion (MainAppState.cpp:60-104).
# sgl's yaw/pitch convention: forward = (cos yaw · cos pitch, sin pitch,
# sin yaw · cos pitch); the default yaw −π/2 looks down −z, matching
# the replicability state (camera at +z, lookat origin).


def _normalize(v):
    v = np.asarray(v, np.float64)
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else np.array([0.0, 0.0, -1.0])


def _quat_rotate(q, v):
    w, x, y, z = q
    u = np.array([x, y, z], np.float64)
    v = np.asarray(v, np.float64)
    return (2.0 * np.dot(u, v) * u
            + (w * w - np.dot(u, u)) * v
            + 2.0 * w * np.cross(u, v))


def camera_from_reference(node: dict) -> Camera:
    """sgl camera JSON → :class:`Camera`."""
    pos_node = node.get("position", {})
    position = (float(pos_node.get("x", 0.0)),
                float(pos_node.get("y", 0.0)),
                float(pos_node.get("z", 0.8)))
    fovy = float(node.get("fovy", math.pi / 4.0))
    up = np.array([0.0, 1.0, 0.0])
    forward = None
    if "yaw" in node and "pitch" in node:
        yaw, pitch = float(node["yaw"]), float(node["pitch"])
        forward = np.array([
            math.cos(yaw) * math.cos(pitch),
            math.sin(pitch),
            math.sin(yaw) * math.cos(pitch),
        ])
    elif "orientation" in node:
        o = node["orientation"]
        q = _normalize([float(o.get(k, 0.0)) for k in "wxyz"])
        forward = _quat_rotate(q, [0.0, 0.0, -1.0])
        up = _quat_rotate(q, [0.0, 1.0, 0.0])
    look_node = node.get("lookat", {})
    lookat = np.array([float(look_node.get(k, 0.0)) for k in "xyz"])
    if forward is None:
        forward = _normalize(lookat - np.asarray(position))
    # Keep the file's look-at distance as the orbit pivot when present,
    # but the *direction* always comes from the orientation (sgl's
    # lookAtLocation is a pivot, not necessarily on the view ray).
    dist = float(np.linalg.norm(lookat - np.asarray(position))) or 1.0
    look_at_point = tuple(np.asarray(position)
                          + _normalize(forward) * dist)
    # Degenerate up (looking straight along ±y with yaw/pitch): fall
    # back to +z so look_at stays well-defined.
    if abs(float(np.dot(_normalize(forward), _normalize(up)))) > 0.999:
        up = np.array([0.0, 0.0, 1.0])
    return Camera(position=tuple(float(c) for c in position),
                  look_at_point=tuple(float(c) for c in look_at_point),
                  up=tuple(float(c) for c in _normalize(up)),
                  fovy=fovy)


def camera_to_reference(cam) -> dict:
    """:class:`Camera` → sgl camera JSON (legacy yaw/pitch form, which
    the reference's loader prefers when present)."""
    position = np.asarray(cam.position, np.float64)
    lookat = np.asarray(cam.look_at_point, np.float64)
    f = _normalize(lookat - position)
    yaw = math.atan2(float(f[2]), float(f[0]))
    pitch = math.asin(max(-1.0, min(1.0, float(f[1]))))
    return {
        "fovy": float(cam.fovy),
        "position": {"x": float(position[0]), "y": float(position[1]),
                     "z": float(position[2])},
        "lookat": {"x": float(lookat[0]), "y": float(lookat[1]),
                   "z": float(lookat[2])},
        "yaw": yaw,
        "pitch": pitch,
    }


# -- enum name tables ------------------------------------------------------

#: IsoSurfaceRayCastingRenderer.hpp:41-43 → our intersection_mode ids.
_SOLVER_FROM_REF = {
    "Linear Interpolation": "linear",
    "Neubauer": "bisection",     # iterative refinement family
    "Marmitt": "marmitt",
    "Schwarze": "analytic",
}
_SOLVER_TO_REF = {
    "linear": "Linear Interpolation",
    "bisection": "Neubauer",
    "marmitt": "Marmitt",
    "analytic": "Schwarze",
}

#: Sampling.hpp:38-40 → diagrams/sampling.py method ids.
_SAMPLING_FROM_REF = {
    "Mean": "mean",
    "Random Uniform": "random",
    "Quasirandom Halton": "halton",
    "Quasirandom Plastic": "plastic",
    "Bayesian Optimization": "bayesian",
}
_SAMPLING_TO_REF = {v: k for k, v in _SAMPLING_FROM_REF.items()}

#: Octree.hpp:40-42 → diagrams/octree.py method ids.
_OCTREE_FROM_REF = {
    "Top Down (ceil)": "topdown",
    "Top Down (PoT)": "topdown_pot",
}
_OCTREE_TO_REF = {v: k for k, v in _OCTREE_FROM_REF.items()}

#: IsoSurfaces.hpp:36 → render/mesh.py technique ids.
_EXTRACTION_FROM_REF = {
    "Marching Cubes": "mc",
    "SnapMC": "snapmc",
}
_EXTRACTION_TO_REF = {v: k for k, v in _EXTRACTION_FROM_REF.items()}

#: DistributionSimilarityRenderer.hpp:61-65 feature modes →
#: diagrams/distribution_similarity.py mode ids.
_ANALYSIS_MODE_FROM_REF = {
    "Grid Cell Neighborhood Correlation Vector":
        "cell_neighborhood_correlations",
    "Grid Cell Member Value Vector": "cell_member_values",
    "Member Grid Cell Value Vector": "member_cell_values",
}
_ANALYSIS_MODE_TO_REF = {v: k for k, v in _ANALYSIS_MODE_FROM_REF.items()}

#: Keys that configure the reference's GPU plumbing, meaningless here;
#: preserved via _ref_extra, not warned.
_SILENT_KEYS = frozenset({
    "data_mode", "device", "use_buffer_tiling", "use_gpu",
    "use_correlation_computation_gpu",
    "use_correlation_computation_gpu_focus",
    "use_field_accuracy_double",
    "network_implementation", "export_file_path",
    # Interactive picking GUI state (PointPicker options — picking is
    # call-site-parameterized here, render/picking.py).
    "fix_picking_z", "fixed_z_plane_percentage",
    # NaN stencil is always applied by the neural calculator.
    "use_data_nan_stencil",
    # Barnes-Hut/momentum schedule internals of the vendored bhtsne;
    # the exact t-SNE here has no approximation theta or lying phase.
    "tsne_theta", "tsne_mom_switch_iter", "tsne_stop_lying_iter",
})


def _field_name(names: list, idx, warnings: list, ctx: str):
    try:
        return names[int(idx)]
    except (IndexError, ValueError, TypeError):
        warnings.append(
            f"{ctx}: scalar field index {idx!r} out of range "
            f"({len(names)} fields); using field 0"
        )
        return names[0] if names else None


def _pop_color_map(s: dict, out: dict, extra: dict, warnings: list,
                   ctx: str, key: str = "color_map") -> None:
    """Import a named colormap with validation: unknown names degrade
    to the component default (with a warning, raw value stashed in
    ``_ref_extra``) instead of raising KeyError at render time."""
    if key not in s:
        return
    name = str(s[key])
    if _dcm.is_known(name):
        out[key] = _dcm.display_name(s.pop(key))
    else:
        warnings.append(f"{ctx}: unknown color map {name!r}; "
                        "using the default")
        extra[key] = s.pop(key)


# -- calculators -----------------------------------------------------------

#: Correlation-calculator keys our settings_to_kwargs accepts verbatim
#: (calculators/correlation.py).
_CORRELATION_PASSTHROUGH = (
    "correlation_measure_type", "correlation_mode", "mi_bins",
    "kmi_neighbors", "kraskov_estimator_index",
    "use_time_lag_correlations", "time_lag_time_step_idx",
    "correlation_field_mode", "restrict_rendering",
    "render_restriction_radius", "distance_metric",
)

def _convert_calculator(type_id: str, state: dict, names: list,
                        warnings: list) -> dict:
    """Reference ``{type, state}`` calculator node → our flat node."""
    s = _coerce_map(state)
    out = {"type": type_id}
    extra = {}

    def take(key):
        return s.pop(key, None)

    if type_id == "correlation":
        for k in _CORRELATION_PASSTHROUGH:
            if k in s:
                out[k] = s.pop(k)
        if "calculate_absolute_value" in s:
            out["calculate_absolute_value"] = bool(
                s.pop("calculate_absolute_value"))
        for axis in "xyz":
            k = f"reference_point_{axis}"
            if k in s:
                out[k] = s.pop(k)
        mode = out.get("correlation_field_mode", "Single")
        if int(s.pop("use_separate_fields", 0)) and mode == "Single":
            mode = out["correlation_field_mode"] = "Separate"
        if mode != "Single":
            if "scalar_field_idx_ref" in s:
                out["scalar_field_name_ref"] = _field_name(
                    names, s.pop("scalar_field_idx_ref"), warnings,
                    type_id)
            if "scalar_field_idx_query" in s:
                out["scalar_field_name"] = _field_name(
                    names, s.pop("scalar_field_idx_query"), warnings,
                    type_id)
        if "scalar_field_idx" in s:
            out["scalar_field_name"] = _field_name(
                names, s.pop("scalar_field_idx"), warnings, type_id)
    elif type_id == "binary_operator":
        if "binary_operator_type" in s:
            out["operator_type"] = s.pop("binary_operator_type")
        for i in (0, 1):
            k = f"scalar_field_idx_{i}"
            if k in s:
                out[f"scalar_field_name_{i}"] = _field_name(
                    names, s.pop(k), warnings, type_id)
    elif type_id == "noise_reduction":
        if "scalar_field_idx" in s:
            out["scalar_field_name"] = _field_name(
                names, s.pop("scalar_field_idx"), warnings, type_id)
        if "sigma" in s:
            out["standard_deviation"] = s.pop("sigma")
        if "standard_deviation" in s:
            out["standard_deviation"] = s.pop("standard_deviation")
        kernel = take("kernel_size")
        if kernel is not None:
            extra["kernel_size"] = kernel
        kind = take("noise_reduction_type")
        if kind not in (None, "Gaussian Blur"):
            warnings.append(
                f"noise_reduction: type {kind!r} not replicated "
                "(Gaussian blur only)")
            extra["noise_reduction_type"] = kind
    elif type_id in ("ensemble_mean", "ensemble_spread"):
        if "scalar_field_idx" in s:
            out["scalar_field_name"] = _field_name(
                names, s.pop("scalar_field_idx"), warnings, type_id)
    elif type_id == "set_predicate":
        for k in ("comparison_operator_type", "comparison_value",
                  "count_lower", "count_upper",
                  # ours-only keys (round-tripping our own exports)
                  "comparison", "aggregation", "threshold",
                  "threshold_upper"):
            if k in s:
                out[k] = s.pop(k)
        if "scalar_field_idx" in s:
            out["scalar_field_name"] = _field_name(
                names, s.pop("scalar_field_idx"), warnings, type_id)
        if int(s.pop("use_fuzzy_logic", 0)):
            # Shared formula either way; the flag only changes the GUI
            # (SetPredicateCalculator.cpp:274 fuzzy accumulation is the
            # count ramp over fuzzy truth values): noted, not refused.
            warnings.append("set_predicate: fuzzy-logic truth "
                            "accumulation approximated by the count ramp")
        if str(s.get("correlation_mode", "Ensemble")) != "Ensemble":
            warnings.append("set_predicate: time-mode aggregation not "
                            "replicated; using ensemble members")
        s.pop("correlation_mode", None)
    elif type_id == "dkl":
        # JAX's converter keeps this branch for a type id its registry
        # does not hold, so convert_reference_state never reaches it.
        if "scalar_field_idx" in s:
            out["scalar_field_name"] = _field_name(
                names, s.pop("scalar_field_idx"), warnings, type_id)
        est = take("estimator_type")
        if est is not None:
            # DKLCalculator.hpp estimator names: "Binned", "k-NN".
            out["estimator"] = ("knn" if "nn" in str(est).lower()
                                else "binned")
        for k in ("mi_bins", "knn_neighbors"):
            if k in s:
                out[k] = s.pop(k)
    elif type_id == "residual_color":
        for i in (0, 1):
            k = f"scalar_field_idx_{i}"
            if k in s:
                out[f"scalar_field_name_{i}"] = _field_name(
                    names, s.pop(k), warnings, type_id)
    else:
        # The velocity family and dkl_calculator: no branch in JAX's
        # converter either, which raises here.
        raise ValueError(f"unknown calculator type {type_id!r}")

    for k, v in s.items():
        extra[k] = v
        if k not in _SILENT_KEYS:
            warnings.append(f"{type_id}: unmapped setting {k!r} "
                            "preserved in _ref_extra")
    if extra:
        out["_ref_extra"] = extra
    return out


# -- renderers -------------------------------------------------------------


def _convert_renderer(type_id: str, state: dict, names: list,
                      warnings: list) -> list:
    """Reference renderer node → a list of our renderer dicts (one per
    visible view — the reference's ``view_visibility`` bitmask can show
    one renderer in several views; our nodes carry a single view)."""
    state = dict(state or {})
    # The visibility bitmask must stay a string ("01" is views, not
    # the number 1) — pull it out before numeric coercion.
    vis = str(state.pop("view_visibility", "1"))
    view_indices = [i for i, c in enumerate(vis) if c == "1"]
    hidden = not view_indices
    if hidden:
        # Configured but visible in no view: keep the node (the
        # reference keeps it in the renderer list) but mark it so the
        # render paths skip it and re-export restores the zero mask.
        view_indices = [0]
    s = _coerce_map(state)
    out = {"type": type_id}
    if hidden:
        out["hidden"] = True
    extra = {}

    def field_from_idx():
        if "selected_field_idx" in s:
            out["field"] = _field_name(
                names, s.pop("selected_field_idx"), warnings, type_id)

    if type_id == "dvr":
        field_from_idx()
        if "attenuation_coefficient" in s:
            out["attenuation"] = float(s.pop("attenuation_coefficient"))
        if "step_size" in s:
            out["step_size"] = float(s.pop("step_size"))
        if "nan_handling" in s:
            out["nan_mode"] = str(s.pop("nan_handling"))
    elif type_id == "iso_ray":
        field_from_idx()
        if "iso_value" in s:
            out["iso_value"] = float(s.pop("iso_value"))
        color = [s.pop(f"iso_surface_color_{c}", None) for c in "rgba"]
        if any(c is not None for c in color):
            out["color"] = tuple(
                float(c) if c is not None else 1.0 for c in color)
        if "close_iso_surface" in s:
            out["closed_surface"] = bool(s.pop("close_iso_surface"))
        solver = s.pop("intersection_solver", None)
        if solver is None and "analytic_intersections" in s:
            solver = ("Schwarze" if int(s.pop("analytic_intersections"))
                      else "Linear Interpolation")
        s.pop("analytic_intersections", None)
        if solver is not None:
            out["intersection_mode"] = _SOLVER_FROM_REF.get(
                str(solver), "bisection")
        if "step_size" in s:
            out["step_size"] = float(s.pop("step_size"))
    elif type_id == "iso_raster":
        field_from_idx()
        if "iso_value" in s:
            out["iso_value"] = float(s.pop("iso_value"))
        color = [s.pop(f"iso_surface_color_{c}", None) for c in "rgba"]
        if any(c is not None for c in color):
            out["color"] = tuple(
                float(c) if c is not None else 1.0 for c in color)
        tech = s.pop("iso_surface_extraction_technique", None)
        if tech is not None:
            out["technique"] = _EXTRACTION_FROM_REF.get(str(tech), "mc")
        if "gamma_snap_mc" in s:
            out["gamma"] = float(s.pop("gamma_snap_mc"))
    elif type_id == "domain_outline":
        if "line_width" in s:
            out["line_width"] = float(s.pop("line_width"))
        if "use_depth_cues" in s:
            extra["use_depth_cues"] = s.pop("use_depth_cues")
    elif type_id == "slice":
        field_from_idx()
        # SliceRenderer persists our exact keys (the oblique-plane
        # support was built against them): normal_x/y/z + plane_dist +
        # lighting_factor + nan_handling + fix_on_ground.
        for k in ("normal_x", "normal_y", "normal_z", "plane_dist",
                  "lighting_factor", "nan_handling", "fix_on_ground"):
            if k in s:
                out[k] = s.pop(k)
        if "fix_on_ground" in out:
            out["fix_on_ground"] = bool(out["fix_on_ground"])
    elif type_id == "world_map":
        src = s.pop("world_map_source", None)
        if src == "Shapefile Rasterizer":
            # A shapefile path is configured at runtime here; keep the
            # intent and let the scene fall back to the graticule when
            # no shapefile key is present.
            out["source"] = "shapefile"
        elif src == "TIFF File":
            out["source"] = "raster"
            warnings.append("world_map: reference downloads its raster; "
                            "set renderer key 'raster' to a local file")
        if "lighting_factor" in s:
            out["lighting_factor"] = float(s.pop("lighting_factor"))
        if "world_map_quality" in s:
            extra["world_map_quality"] = s.pop("world_map_quality")
    elif type_id == "diagram":
        _convert_diagram(s, out, warnings)
    elif type_id == "scatter_plot":
        for ref_key, our_key in (("field0", "field"),
                                 ("field1", "field_b")):
            if ref_key in s:
                out[our_key] = _field_name(
                    names, s.pop(ref_key), warnings, type_id)
        if int(s.pop("use_same_field", 0)):
            out["field_b"] = out.get("field")
        for k in ("point_size", "point_color", "correlation_mode"):
            if k in s:
                out[k] = s.pop(k)
    elif type_id == "correlation_matrix":
        for k in ("correlation_measure_type",
                  "use_all_ensemble_members", "use_all_time_steps"):
            if k in s:
                out[k] = s.pop(k)
        _pop_color_map(s, out, extra, warnings, type_id, "color_map")
        if "scalar_field_selection" in s:
            extra["scalar_field_selection"] = s.pop(
                "scalar_field_selection")
    elif type_id == "time_series_correlation":
        for ref_key, our_key in (
                ("correlation_measure_type", "measure"),
                ("mi_bins", "mi_bins"),
                ("kmi_neighbors", "kmi_neighbors"),
                ("sliding_window_length", "window"),
                ("time_series_file_path", "path")):
            if ref_key in s:
                out[our_key] = s.pop(ref_key)
        _pop_color_map(s, out, extra, warnings, type_id, "color_map")
        if "calculate_absolute_value" in s:
            out["absolute"] = bool(s.pop("calculate_absolute_value"))
        if "model_file_path" in s:
            out["estimator"] = "mine"
            out["model_path"] = s.pop("model_file_path")
    elif type_id == "distribution_similarity":
        for ref_key, our_key in (
                ("correlation_measure_type", "measure"),
                ("dbscan_epsilon", "dbscan_eps"),
                ("dbscan_minpts", "dbscan_min_pts"),
                ("num_sampled_points", "max_points"),
                ("tsne_perplexity", "perplexity"),
                ("tsne_max_iter", "tsne_num_iters"),
                ("tsne_random_seed", "tsne_seed"),
                ("neighborhood_radius", "neighborhood_radius"),
                ("mi_bins", "mi_bins"),
                ("kmi_neighbors", "kmi_neighbors")):
            if ref_key in s:
                out[our_key] = s.pop(ref_key)
        mode = s.pop("distribution_analysis_mode", None)
        if mode is not None:
            out["mode"] = _ANALYSIS_MODE_FROM_REF.get(
                str(mode), "cell_member_values")
        pattern = s.pop("sampling_pattern", None)
        if pattern is not None:
            out["sampling_pattern"] = ("plastic" if "plastic"
                                       in str(pattern).lower() else "all")
        if "use_dbscan_clustering" in s:
            out["use_dbscan"] = bool(s.pop("use_dbscan_clustering"))
    else:
        # convert_reference_state filters by RENDERING_MODE_IDS first.
        raise ValueError(f"unknown renderer type {type_id!r}")

    # Diagram-family charts draw in their configured dock view.
    if "diagram_view" in s:
        view_indices = [int(s.pop("diagram_view"))]
    # align_with_parent_window=1 → the chart fills its parent view
    # (ScatterPlotChart::updateSizeByParent: offset 0, full size;
    # DiagramRenderer.cpp:1759,1909 persists the flag). Mapped onto
    # the overlay placement keys so an imported reference scene draws
    # the chart where the reference drew it.
    if "align_with_parent_window" in s:
        if bool(s.pop("align_with_parent_window")):
            out["overlay_anchor"] = "center"
            out["overlay_frac"] = 1.0

    for k, v in s.items():
        extra[k] = v
        if k not in _SILENT_KEYS:
            warnings.append(f"{type_id}: unmapped setting {k!r} "
                            "preserved in _ref_extra")
    if extra:
        out.setdefault("_ref_extra", {}).update(extra)

    nodes = []
    for v in view_indices:
        node = dict(out)
        node["view"] = v
        nodes.append(node)
    return nodes


def _convert_diagram(s: dict, out: dict, warnings: list) -> None:
    """DiagramRenderer settings → our HEB drill-down node keys."""
    simple = {
        "correlation_measure_type": "measure",
        "correlation_mode": "correlation_mode",
        "beta": "beta",
        "curve_thickness": "curve_thickness",
        "curve_opacity_context": "curve_opacity_context",
        "curve_opacity_focus": "curve_opacity_focus",
        "mi_bins": "mi_bins",
        "kmi_neighbors": "kmi_neighbors",
        "num_samples": "num_samples",
        "num_samples_focus": "num_samples_focus",
        "num_init_samples": "num_init_samples",
        "num_bo_iterations": "num_bo_iterations",
        "opacity_by_value": "opacity_by_value",
        "outer_ring_size_pct": "outer_ring_size_pct",
        "desaturate_unselected_ring": "desaturate_unselected_ring",
        "diagram_type": "diagram_type",
        "line_count_factor_context": "max_chords",
        "line_count_factor_focus": "max_chords_focus",
    }
    for ref_key, our_key in simple.items():
        if ref_key in s:
            out[our_key] = s.pop(ref_key)
    if "use_absolute_correlation_measure" in s:
        out["absolute"] = bool(s.pop("use_absolute_correlation_measure"))
    for ref_key, our_key in (("sampling_method_type", "sampling_method"),
                             ("sampling_method_type_focus",
                              "sampling_method_focus")):
        if ref_key in s:
            out[our_key] = _SAMPLING_FROM_REF.get(
                str(s.pop(ref_key)), "plastic")
    if not int(s.pop("use_separate_sampling_method_focus", 1)):
        out.pop("sampling_method_focus", None)
    if "octree_method" in s:
        out["octree_method"] = _OCTREE_FROM_REF.get(
            str(s.pop("octree_method")), "topdown")
    # Per-axis downscaling: the reference writes downscaling_factor_x/
    # _y/_z (and a typo'd legacy downscaling_factor__z) plus focus
    # variants.
    for prefix, our_key in (("downscaling_factor", "downsample_xyz"),
                            ("downscaling_factor_focus",
                             "downsample_focus_xyz")):
        keys = [f"{prefix}_{ax}" for ax in "xyz"]
        legacy_z = s.pop(f"{prefix}__z", None)
        if any(k in s for k in keys) or legacy_z is not None:
            fz = s.pop(keys[2], legacy_z)
            fx = s.pop(keys[0], None)
            fy = s.pop(keys[1], None)
            base = next((v for v in (fx, fy, fz) if v is not None), 1)
            out[our_key] = tuple(int(v) if v is not None else int(base)
                                 for v in (fx, fy, fz))
    for lo_key, hi_key, our_key in (
            ("correlation_range_lower", "correlation_range_upper",
             "correlation_range"),
            ("cell_distance_range_lower", "cell_distance_range_upper",
             "cell_distance_range")):
        lo, hi = s.pop(lo_key, None), s.pop(hi_key, None)
        if lo is not None or hi is not None:
            out[our_key] = (float(lo) if lo is not None else 0.0,
                            float(hi) if hi is not None else float("inf"))
    # Named colormaps: the first field's chord map and the variance
    # ring map are honored (DiagramRenderer.cpp:1642-1670); further
    # per-field maps ride _ref_extra until multi-field charts exist.
    for ref_key, our_key in (("color_map_0", "color_map"),
                             ("color_map_variance",
                              "color_map_variance")):
        if ref_key in s:
            name = str(s[ref_key])
            if _dcm.is_known(name):
                out[our_key] = _dcm.display_name(s.pop(ref_key))
    # The drill-down stack draws its context chart in one view and
    # focus charts in another (DiagramRenderer.cpp:1856-1857). The
    # context index selects the node's dock view (the generic
    # diagram_view path); the focus index rides on the node.
    if "context_diagram_view" in s:
        s["diagram_view"] = s.pop("context_diagram_view")
    if "focus_diagram_view" in s:
        out["focus_view"] = int(s.pop("focus_diagram_view"))
    for k in ("downscaling_power_of_two", "scalar_field_selection",
              "render_only_last_focus_diagram", "diagram_radius",
              "use_global_std_dev_range",
              "separate_color_variance_and_correlation",
              "show_selected_regions_by_color", "use_neon_selection_colors",
              "use_opaque_selection_boxes", "use_alignment_rotation",
              "show_only_selected_variable_in_focus_diagrams"):
        if k in s:
            out.setdefault("_ref_extra", {})[k] = s.pop(k)
    # Field color maps arrive as color_map_<i> keys.
    for k in [k for k in list(s) if str(k).startswith("color_map")]:
        out.setdefault("_ref_extra", {})[k] = s.pop(k)


# -- whole-document conversion ---------------------------------------------


def convert_reference_state(doc: dict, dataset_field_names: list,
                            dataset: dict | None = None):
    """Reference state JSON → our scene-state schema.

    Args:
      doc: parsed reference state file.
      dataset_field_names: scalar-field names of the loaded dataset
        (pre-calculator), in the dataset's field order.
      dataset: optional dataset descriptor for the output doc
        (overrides what ``volume_data`` implies).

    Returns:
      ``(our_doc, warnings)`` — ``our_doc`` matches
      ``Scene.save_state``'s schema.

    Raises:
      NotImplementedError: for a calculator type the port lacks, naming
        its ROADMAP item.
    """
    # app/state.py imports this module.
    from correrender_tpu_torch.app.state import RENDERING_MODE_IDS

    warnings: list[str] = []
    out: dict = {"version": 1}

    vol = doc.get("volume_data", {}) or {}
    ds = dict(dataset or {})
    if not ds:
        if "filename" in vol:
            ds = {"filename": vol["filename"]}
        elif "name" in vol:
            ds = {"name": vol["name"]}
    out["dataset"] = ds
    out["current_time"] = int(vol.get("current_time_step_idx", 0))
    out["current_member"] = int(vol.get("current_ensemble_idx", 0))

    # Cameras: per-view camera, or the global one when synced.
    global_cam_node = doc.get("global_camera")
    views_node = doc.get("views") or []
    views = []
    for view in views_node:
        if view.get("sync_with_global_camera", True) or \
                "camera" not in view:
            cam_node = global_cam_node or view.get("camera") or {}
        else:
            cam_node = view["camera"]
        views.append(cam_node)
    if not views:
        views = [global_cam_node or {}]
    out["views"] = [
        {"camera": _camera_node_to_ours(cam_node)} for cam_node in views
    ]

    # Calculators grow the field-name list for index resolution.
    names = list(dataset_field_names)
    calculators = []
    known_calcs = known_calculator_types()
    for node in doc.get("calculators", []) or []:
        type_id = node.get("type", "correlation")
        if type_id in NOT_PORTED:
            raise NotImplementedError(
                f"calculator type {type_id!r} of the reference state is "
                f"not ported yet (ROADMAP {NOT_PORTED[type_id]})")
        if type_id not in known_calcs:
            # Dropping the node must NOT shift later field indices:
            # the reference's field list would have contained this
            # calculator's output, so a placeholder keeps positions.
            warnings.append(f"unknown calculator type {type_id!r} "
                            "skipped (placeholder keeps field indices)")
            names.append(f"{type_id} Output")
            continue
        converted = _convert_calculator(
            type_id, node.get("state", {}), names, warnings)
        calculators.append(converted)
        try:
            probe = dict(converted)
            probe.pop("type")
            probe.pop("_ref_extra", None)
            calc = calculator_from_settings(type_id, probe)
            names.append(calc.output_name)
        except Exception as exc:  # index resolution degrades gracefully
            warnings.append(f"{type_id}: could not derive output name "
                            f"({exc}); later field indices may shift")
            names.append(f"{type_id} Output")
    out["calculators"] = calculators

    renderers = []
    for node in doc.get("renderers", []) or []:
        type_id = node.get("type", "dvr")
        if type_id not in RENDERING_MODE_IDS:
            warnings.append(f"unknown renderer type {type_id!r} skipped")
            continue
        renderers.extend(_convert_renderer(
            type_id, node.get("state", {}), names, warnings))
    out["renderers"] = renderers

    # Transfer functions: a list ordered like the final field list.
    tf_nodes = vol.get("transfer_functions", []) or []
    tfs = {}
    for i, tf_node in enumerate(tf_nodes):
        if i >= len(names):
            warnings.append(f"transfer function {i} has no matching "
                            "field; skipped")
            continue
        xml = tf_node.get("data", "")
        rng = tf_node.get("selected_range", {}) or {}
        domain = (float(rng.get("min", 0.0)), float(rng.get("max", 1.0)))
        if domain[0] == domain[1]:
            domain = (domain[0], domain[0] + 1.0)
        if not xml:
            continue
        try:
            tf = tf_from_xml_string(xml, domain=domain)
        except Exception as exc:
            warnings.append(f"transfer function {i}: XML parse failed "
                            f"({exc}); skipped")
            continue
        entry = tf.to_dict()   # carries lut + source control points
        if not tf_node.get("is_selected_range_fixed", True):
            entry["range_fixed"] = False
        tfs[names[i]] = entry
    out["transfer_functions"] = tfs

    if "window_size" in doc:
        ws = doc["window_size"]
        out["window_size"] = [int(ws.get("x", 1920)), int(ws.get("y", 1080))]
    if "dock_data" in doc:
        # ImGui ini layout is GUI-specific; derive a row-per-view grid.
        out["dock_layout"] = [[i] for i in range(len(out["views"]))]

    return out, warnings


def _camera_node_to_ours(cam_node: dict) -> dict:
    cam = camera_from_reference(cam_node or {})
    return {
        "position": list(cam.position),
        "look_at": list(cam.look_at_point),
        "up": list(cam.up),
        "fovy": cam.fovy,
    }


# -- export ----------------------------------------------------------------


def reference_state_from_scene(scene, dataset: dict | None = None,
                               window_size=None) -> dict:
    """Build a reference-app state document from a live scene.

    The inverse of :func:`convert_reference_state`: cameras in sgl
    form, calculators/renderers as ``{type, state}`` SettingsMap nodes
    (string values, reference key names, field indices), transfer
    functions as sgl TF-widget XML.
    """
    vd = scene.volume_data
    names = vd.field_names
    name_to_idx = {n: i for i, n in enumerate(names)}

    if window_size is None:
        # An imported reference state carries its window size through.
        window_size = getattr(scene, "window_size", None) or (1920, 1080)
    doc: dict = {
        "window_size": {"x": int(window_size[0]),
                        "y": int(window_size[1])},
        "global_camera": camera_to_reference(scene.views[0]),
        "views": [
            {
                "name": f"3D View {i + 1}##data_view_{i}",
                "sync_with_global_camera": i == 0,
                **({} if i == 0
                   else {"camera": camera_to_reference(cam)}),
            }
            for i, cam in enumerate(scene.views)
        ],
        "dock_data": "",
    }

    calculators = []
    for calc in vd.calculators.values():
        state = {}
        settings = calc.get_settings()
        extra = dict(getattr(calc, "_ref_extra", {}) or {})
        for key, value in settings.items():
            key, value = _settings_key_to_reference(
                key, value, name_to_idx)
            if key is not None:
                state[key] = _stringify(value)
        for key, value in extra.items():
            state.setdefault(key, _stringify(value))
        if state.get("correlation_field_mode", "Single") == "Single":
            # The reference writes the ref/query indices only for
            # Separate modes (CorrelationCalculator.cpp:536-541).
            state.pop("scalar_field_idx_ref", None)
            state.pop("scalar_field_idx_query", None)
        elif "correlation_field_mode" in state:
            # Separate modes read scalar_field_idx_query/_ref, not
            # scalar_field_idx (CorrelationCalculator.cpp:430-443).
            if "scalar_field_idx" in state:
                state["scalar_field_idx_query"] = state.pop(
                    "scalar_field_idx")
        calculators.append({"type": calc.type_id, "state": state})
    doc["calculators"] = calculators

    renderers = []
    num_views = max(len(scene.views), 1)
    for node in scene.renderers:
        renderers.append(_renderer_node_to_reference(
            node, name_to_idx, num_views))
    doc["renderers"] = renderers

    dataset = dataset or scene.dataset_info or {}
    vol_node: dict = {}
    if "name" in dataset:
        vol_node["name"] = dataset["name"]
    elif "filename" in dataset:
        vol_node["filename"] = dataset["filename"]
    vol_node["current_time_step_idx"] = int(scene.current_time)
    vol_node["current_ensemble_idx"] = int(scene.current_member)
    tf_nodes = []
    for name in names:
        tf = scene.transfer_functions.get(name)
        if tf is None:
            tf_nodes.append({"data": ""})
            continue
        lo, hi = tf.domain
        tf_nodes.append({
            "data": tf_to_xml_string(tf),
            "selected_range": {"min": float(lo), "max": float(hi)},
            "is_selected_range_fixed": True,
        })
    vol_node["transfer_functions"] = tf_nodes
    doc["volume_data"] = vol_node
    return doc


def _measure_id(value) -> str:
    """Display name or id → CORRELATION_MEASURE_TYPE_IDS id string."""
    name_to_measure = {v: k for k, v in MEASURE_NAMES.items()}
    measure = name_to_measure.get(value)
    if measure is None:
        measure = measure_from_id(value)
    return measure.value


def _settings_key_to_reference(key: str, value, name_to_idx: dict):
    """Our get_settings key/value → reference SettingsMap key/value."""
    if key == "correlation_measure_type":
        # Our get_settings writes the GUI display name; the reference
        # persists CORRELATION_MEASURE_TYPE_IDS ("pearson", ...).
        return key, _measure_id(value)
    if key == "scalar_field_name":
        return "scalar_field_idx", name_to_idx.get(value, 0)
    if key in ("scalar_field_name_0", "scalar_field_name_1"):
        return f"scalar_field_idx_{key[-1]}", name_to_idx.get(value, 0)
    if key == "scalar_field_name_ref":
        return "scalar_field_idx_ref", name_to_idx.get(value, 0)
    if key == "operator_type":
        return "binary_operator_type", value
    if key == "standard_deviation":
        return "sigma", value
    if key == "comparison":
        glyph = {v: k for k, v in COMPARISON_GLYPHS.items()}.get(value)
        if glyph is not None:
            return "comparison_operator_type", glyph
        return "comparison", value     # ours-only ("between")
    if key == "threshold":
        return "comparison_value", value
    if key == "estimator":
        return "estimator_type", ("k-NN" if value == "knn" else "Binned")
    if key == "aggregation" and value == "count_range":
        return None, None              # implied by count_lower/upper
    return key, value


def _renderer_node_to_reference(node: dict, name_to_idx: dict,
                                num_views: int) -> dict:
    node = dict(node)
    type_id = node.pop("type")
    view = int(node.pop("view", 0))
    extra = node.pop("_ref_extra", {}) or {}
    state: dict = {}
    vis = ["0"] * max(num_views, view + 1)
    if not node.pop("hidden", False):
        vis[view] = "1"
    state["view_visibility"] = "".join(vis)

    def put(ref_key, value):
        state[ref_key] = _stringify(value)

    # Diagram placement: the reference persists the dock view per
    # diagram renderer (context/focus pair for the drill-down stack,
    # DiagramRenderer.cpp:1856-1857; plain diagram_view for the rest).
    if type_id == "diagram":
        put("context_diagram_view", view)
        put("focus_diagram_view",
            int(node.pop("focus_view", view)))
    elif type_id in ("scatter_plot", "correlation_matrix",
                     "time_series_correlation",
                     "distribution_similarity"):
        put("diagram_view", view)

    for key, value in node.items():
        if key == "field" and type_id == "scatter_plot":
            put("field0", name_to_idx.get(value, 0))
        elif key == "field":
            put("selected_field_idx", name_to_idx.get(value, 0))
        elif key == "field_b" and type_id == "scatter_plot":
            put("field1", name_to_idx.get(value, 0))
        elif key == "attenuation":
            put("attenuation_coefficient", value)
        elif key == "nan_mode":
            put("nan_handling", value)
        elif key == "color" and type_id in ("iso_ray", "iso_raster"):
            for c, v in zip("rgba", value):
                put(f"iso_surface_color_{c}", float(v))
        elif key == "closed_surface":
            put("close_iso_surface", value)
        elif key == "intersection_mode":
            put("intersection_solver",
                _SOLVER_TO_REF.get(value, "Neubauer"))
        elif key == "technique":
            put("iso_surface_extraction_technique",
                _EXTRACTION_TO_REF.get(value, "Marching Cubes"))
        elif key == "gamma":
            put("gamma_snap_mc", value)
        elif key == "sampling_method":
            put("sampling_method_type",
                _SAMPLING_TO_REF.get(value, "Quasirandom Plastic"))
        elif key == "sampling_method_focus":
            put("sampling_method_type_focus",
                _SAMPLING_TO_REF.get(value, "Quasirandom Plastic"))
        elif key == "octree_method":
            put("octree_method", _OCTREE_TO_REF.get(
                value, "Top Down (ceil)"))
        elif key == "absolute":
            # The DiagramRenderer persists this flag under its own
            # name; the other diagram renderers share the calculator
            # key (DiagramRenderer.cpp:1861 vs
            # TimeSeriesCorrelationRenderer/DistributionSimilarity).
            put("use_absolute_correlation_measure"
                if type_id == "diagram" else "calculate_absolute_value",
                value)
        elif key == "measure":
            put("correlation_measure_type", _measure_id(value))
        elif key == "mode" and type_id == "distribution_similarity":
            put("distribution_analysis_mode", _ANALYSIS_MODE_TO_REF.get(
                value, "Grid Cell Member Value Vector"))
        elif key == "sampling_pattern":
            put("sampling_pattern", "Quasirandom Plastic"
                if value == "plastic" else "All")
        elif key == "use_dbscan":
            put("use_dbscan_clustering", value)
        elif key == "perplexity":
            put("tsne_perplexity", value)
        elif key == "tsne_num_iters":
            put("tsne_max_iter", value)
        elif key == "tsne_seed":
            put("tsne_random_seed", value)
        elif key == "model_path" and type_id == "time_series_correlation":
            put("model_file_path", value)
        elif key == "estimator" and type_id == "time_series_correlation":
            pass  # implied by model_file_path presence
        elif key == "downsample_xyz":
            for ax, v in zip("xyz", value):
                put(f"downscaling_factor_{ax}", int(v))
        elif key == "downsample_focus_xyz":
            for ax, v in zip("xyz", value):
                put(f"downscaling_factor_focus_{ax}", int(v))
        elif key == "correlation_range":
            put("correlation_range_lower", float(value[0]))
            put("correlation_range_upper", float(value[1]))
        elif key == "cell_distance_range":
            put("cell_distance_range_lower", float(value[0]))
            hi = value[1]
            put("cell_distance_range_upper",
                float(hi) if math.isfinite(float(hi)) else 1e9)
        elif key == "max_chords":
            put("line_count_factor_context", value)
        elif key == "max_chords_focus":
            put("line_count_factor_focus", value)
        elif key == "color_map" and type_id == "diagram":
            put("color_map_0", _dcm.display_name(value))
        elif key in ("color_map", "color_map_variance"):
            # Other diagram-family renderers persist a plain color_map
            # by display name (e.g. TimeSeriesCorrelationRenderer.cpp:894).
            put(key, _dcm.display_name(value))
        elif key == "window" and type_id == "time_series_correlation":
            put("sliding_window_length", value)
        elif key == "path" and type_id == "time_series_correlation":
            put("time_series_file_path", value)
        elif key == "dbscan_eps":
            put("dbscan_epsilon", value)
        elif key == "dbscan_min_pts":
            put("dbscan_minpts", value)
        elif key == "max_points" and type_id == "distribution_similarity":
            put("num_sampled_points", value)
        elif key == "overlay_anchor":
            # "center" + full frac is the reference's
            # align_with_parent_window placement (the only diagram
            # placement it persists); corner anchors have no
            # reference analogue → align off.
            put("align_with_parent_window", value == "center")
        elif key in ("overlay_frac", "overlay_opacity", "overlay"):
            pass  # implied by align_with_parent_window / ours-only
        else:
            put(key, value)
    for key, value in extra.items():
        state.setdefault(key, _stringify(value))
    return {"type": type_id, "state": state}
