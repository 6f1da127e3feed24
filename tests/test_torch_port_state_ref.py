"""PyTorch port (correrender_tpu_torch) vs the JAX package: the
reference app's state files (``app/state_ref.py``) and the Scene's import
and export of them.

Documents are authored here in the reference format (MainAppState.cpp:
106-205, the TF widget's XML), with this test's own values. The port's
converted documents and exports must equal the JAX package's as JSON;
frames of loaded scenes are held at the Scene tests' bars (max-abs 1e-2,
SSIM 0.995), a round trip through the port's own export at 1e-6. A
calculator type the port does not hold yet raises with its ROADMAP item.
"""

import copy
import json
import logging

import numpy as np
import pytest
import torch

from correrender_tpu.app import state_ref as jax_state_ref
from correrender_tpu.app.state import Scene as JaxScene
from correrender_tpu.calculators.correlation import (
    CorrelationCalculator as JaxCalculator,
)
from correrender_tpu.core.fields import GridMetadata as JaxGrid
from correrender_tpu.core.fields import VolumeData as JaxVolumeData
from correrender_tpu.render import Camera as JaxCamera
from correrender_tpu.render import TransferFunction as JaxTF
from correrender_tpu.utils import metrics as jmetrics

from correrender_tpu_torch.app import state_ref
from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.calculators.correlation import (
    CorrelationCalculator,
)
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.interop import (
    camera_from_fields,
    transfer_function_from_arrays,
)
from correrender_tpu_torch.render.tf import tf_from_xml_string

IMAGE = (96, 64)

TF_XML = (
    '<TransferFunction colorspace="sRGB" '
    'interpolation_colorspace="Linear RGB">\n'
    '    <OpacityPoints>\n'
    '        <OpacityPoint position="0" opacity="0.8"/>\n'
    '        <OpacityPoint position="0.5" opacity="0"/>\n'
    '        <OpacityPoint position="1" opacity="0.8"/>\n'
    '    </OpacityPoints>\n'
    '    <ColorPoints color_data="ushort">\n'
    '        <ColorPoint position="0" r="0" g="32768" b="65535"/>\n'
    '        <ColorPoint position="1" r="65535" g="16384" b="0"/>\n'
    '    </ColorPoints>\n'
    '</TransferFunction>\n\x00')


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def ensemble(seed=0, shape=(12, 1, 16, 20, 24)):
    """(E, T, Z, Y, X) float32 around a smooth shared signal."""
    rng = np.random.default_rng(seed)
    es, ts, zs, ys, xs = shape
    z, y, x = np.meshgrid(*(np.linspace(-1, 1, n) for n in (zs, ys, xs)),
                          indexing="ij")
    base = np.sin(3 * x) * np.cos(2 * y) + z
    return np.stack([[base * (1 + 0.3 * rng.normal()) + 0.4 * rng.normal(
        size=base.shape) for _ in range(ts)] for _ in range(es)]).astype(
            np.float32)


def volumes(data):
    es, ts, zs, ys, xs = data.shape
    grid = dict(xs=xs, ys=ys, zs=zs, ts=ts, es=es)
    jvd = JaxVolumeData(JaxGrid(**grid))
    tvd = VolumeData(GridMetadata(**grid), device="cpu")
    for vd in (jvd, tvd):
        vd.add_field("data", lambda t, e: data[e, t])
    return jvd, tvd


def correlation_state(**extra):
    return {"type": "correlation", "state": {
        "calculate_absolute_value": "0",
        "correlation_measure_type": "pearson",
        "correlation_mode": "Ensemble", "data_mode": "Buffer Array",
        "device": "CUDA", "fix_picking_z": "1", "kmi_neighbors": "3",
        "kraskov_estimator_index": "1", "mi_bins": "40",
        "reference_point_x": "8", "reference_point_y": "10",
        "reference_point_z": "6", "scalar_field_idx": "0",
        "use_buffer_tiling": "1", "use_separate_fields": "0",
        "an_unknown_key": "7", **extra}}


def reference_doc(renderers=None, calculators=None):
    """A reference-format document over the field ``data`` and one
    correlation calculator (field 1)."""
    return {
        "window_size": {"x": 1280, "y": 720},
        "global_camera": {
            "fovy": 0.9272952079772949,
            "lookat": {"x": 0.0, "y": 0.0, "z": 0.0},
            "pitch": -0.35, "yaw": -1.2,
            "position": {"x": 0.25, "y": 0.3, "z": 0.7},
        },
        "views": [
            {"name": "3D View 1##data_view_0",
             "sync_with_global_camera": True},
            {"name": "3D View 2##data_view_1",
             "sync_with_global_camera": False,
             "camera": {"fovy": 0.78, "position": {"x": 0.4, "y": 0.3,
                                                   "z": 0.4},
                        "orientation": {"w": 0.9, "x": -0.2, "y": 0.35,
                                        "z": 0.0}}},
        ],
        "dock_data": "[Window][###data_view_0]\nPos=0,0\n",
        "calculators": [correlation_state()] if calculators is None
        else calculators,
        "renderers": RENDER_NODES if renderers is None else renderers,
        "volume_data": {
            "name": "test_ensemble",
            "current_time_step_idx": 0, "current_ensemble_idx": 2,
            "transfer_functions": [
                {"data": TF_XML, "selected_range": {"min": -2.0, "max": 2.0},
                 "is_selected_range_fixed": True},
                {"data": TF_XML, "selected_range": {"min": -1.0, "max": 1.0},
                 "is_selected_range_fixed": False},
            ],
        },
    }


#: Renderers the port draws, in the reference's keys (view 0).
VIEW_NODES = [
    {"type": "dvr", "state": {"attenuation_coefficient": "100",
                              "selected_field_idx": "1",
                              "view_visibility": "10"}},
    {"type": "slice", "state": {
        "selected_field_idx": "1", "normal_x": "1", "normal_y": "1",
        "normal_z": "1", "plane_dist": "0.01", "lighting_factor": "0.5",
        "nan_handling": "yellow", "fix_on_ground": "0",
        "view_visibility": "11"}},
    {"type": "domain_outline", "state": {"line_width": "0.002",
                                         "use_depth_cues": "1",
                                         "view_visibility": "10"}},
    {"type": "world_map", "state": {"world_map_source": "Shapefile "
                                    "Rasterizer", "lighting_factor": "0.3",
                                    "view_visibility": "10"}},
]

#: Every renderer family, for the conversion (not drawn).
RENDER_NODES = VIEW_NODES + [
    {"type": "iso_ray", "state": {
        "analytic_intersections": "0", "close_iso_surface": "1",
        "intersection_solver": "Marmitt", "iso_surface_color_r": "0.3",
        "iso_surface_color_g": "0.6", "iso_surface_color_b": "0.9",
        "iso_surface_color_a": "1", "iso_value": "0.25",
        "selected_field_idx": "0", "step_size": "0.25",
        "view_visibility": "01"}},
    {"type": "iso_raster", "state": {
        "iso_value": "0.1", "iso_surface_extraction_technique": "SnapMC",
        "gamma_snap_mc": "0.3", "view_visibility": "00"}},
    {"type": "world_map", "state": {"world_map_source": "TIFF File",
                                    "world_map_quality": "2"}},
    {"type": "diagram", "state": {
        "correlation_measure_type": "kendall", "beta": "0.6",
        "sampling_method_type": "Quasirandom Halton",
        "octree_method": "Top Down (PoT)", "downscaling_factor_x": "4",
        "downscaling_factor__z": "2", "color_map_0": "cool to warm",
        "color_map_variance": "Viridis", "context_diagram_view": "1",
        "focus_diagram_view": "0", "correlation_range_lower": "0.2",
        "use_absolute_correlation_measure": "1", "diagram_radius": "3"}},
    {"type": "scatter_plot", "state": {"field0": "0", "field1": "1",
                                       "point_size": "3",
                                       "align_with_parent_window": "1",
                                       "diagram_view": "1"}},
    {"type": "correlation_matrix", "state": {
        "correlation_measure_type": "spearman", "color_map": "RdBu",
        "scalar_field_selection": "0110"}},
    {"type": "correlation_matrix", "state": {"color_map": "no such map"}},
    {"type": "time_series_correlation", "state": {
        "correlation_measure_type": "pearson", "sliding_window_length": "8",
        "time_series_file_path": "ts.nc", "color_map": "Seismic"}},
    {"type": "distribution_similarity", "state": {
        "distribution_analysis_mode": "Member Grid Cell Value Vector",
        "sampling_pattern": "Quasirandom Plastic", "tsne_perplexity": "20",
        "use_dbscan_clustering": "1"}},
    {"type": "a_future_renderer", "state": {}},
]


def as_json(obj):
    return json.loads(json.dumps(obj))


def test_format_detection_equals_jax():
    docs = [reference_doc(), {"version": 1, "views": []},
            {"renderers": [{"type": "dvr", "state": {}}]},
            {"calculators": [{"type": "correlation"}]}, {"dock_data": ""}]
    for doc in docs:
        assert (state_ref.is_reference_state(doc)
                == jax_state_ref.is_reference_state(doc))


@pytest.mark.parametrize("node", [
    {}, reference_doc()["global_camera"], reference_doc()["views"][1]["camera"],
    {"position": {"x": 0.0, "y": 0.8, "z": 0.0}, "yaw": 0.0,
     "pitch": -1.5707963},  # straight down: the degenerate up
    {"position": {"x": 0.1, "y": 0.2, "z": 0.5},
     "lookat": {"x": 0.0, "y": 0.1, "z": 0.0}},
])
def test_cameras_equal_jax(node):
    got = state_ref.camera_from_reference(node)
    want = jax_state_ref.camera_from_reference(node)
    for field in ("position", "look_at_point", "up", "fovy"):
        assert getattr(got, field) == getattr(want, field)
    assert (state_ref.camera_to_reference(got)
            == jax_state_ref.camera_to_reference(want))


@pytest.mark.parametrize("calculators", [
    [correlation_state()],
    [correlation_state(correlation_field_mode="Separate",
                       scalar_field_idx_ref="0", scalar_field_idx_query="0",
                       correlation_measure_type="spearman")],
    # Types neither package knows are skipped, keeping field indices.
    [{"type": "dkl", "state": {}}, correlation_state(scalar_field_idx="0")],
    [correlation_state(scalar_field_idx="5")],  # out of range: field 0
])
def test_convert_reference_state_equals_jax(calculators):
    doc = reference_doc(calculators=calculators)
    got, got_warnings = state_ref.convert_reference_state(
        copy.deepcopy(doc), ["data"])
    want, want_warnings = jax_state_ref.convert_reference_state(
        copy.deepcopy(doc), ["data"])
    assert as_json(got) == as_json(want)
    assert got_warnings == want_warnings


def jax_and_port_scenes(data, tfs=True):
    """The same live scene on both sides: two views, a Pearson calculator,
    renderers of every family, named and control-point TFs."""
    jvd, tvd = volumes(data)
    jcams = [JaxCamera(position=(0.25, 0.3, 0.7)),
             JaxCamera(position=(0.4, 0.2, 0.5))]
    out = []
    for vd, scene_cls, calc_cls, cams in (
            (jvd, JaxScene, JaxCalculator, jcams),
            (tvd, Scene, CorrelationCalculator, [tcam(c) for c in jcams])):
        scene = scene_cls(vd, cams)
        name = scene.add_calculator(calc_cls(
            field_name="data", reference_point=(8, 10, 6), measure="kendall",
            use_render_restriction=True, render_restriction_radius=0.2))
        scene.add_renderer("dvr", field=name, attenuation=80.0)
        scene.add_renderer("slice", view=1, field=name, normal_x=0.3,
                           normal_y=0.0, normal_z=1.0, lighting_factor=0.5)
        scene.add_renderer("domain_outline", line_width=2.0)
        scene.add_renderer("world_map", shapefile="land.shp")
        scene.add_renderer("iso_ray", field="data", iso_value=0.3,
                           color=(0.2, 0.4, 0.6, 1.0),
                           intersection_mode="analytic", hidden=True)
        scene.add_renderer("diagram", view=1, measure="spearman",
                           color_map="Cool to Warm", downsample_xyz=(4, 4, 2),
                           cell_distance_range=(0.0, float("inf")))
        scene.add_renderer("correlation_matrix", color_map="rdbu",
                           overlay_anchor="center", overlay_frac=1.0)
        out.append((scene, name))
    if tfs:
        jtf = JaxTF.from_colormap("Cividis", domain=(-1, 1))
        lut_only = JaxTF(lut=JaxTF.from_colormap("viridis").lut,
                         domain=(-3.0, 2.0))
        for (scene, name), convert in zip(out, (lambda t: t, ttf_of)):
            scene.transfer_functions[name] = convert(jtf)
            scene.transfer_functions["data"] = convert(lut_only)
    return out


def tcam(jcam):
    return camera_from_fields(jcam.position, jcam.look_at_point, jcam.up,
                              jcam.fovy, jcam.z_near, jcam.z_far)


def ttf_of(jtf):
    return transfer_function_from_arrays(
        np.asarray(jtf.lut), jtf.domain, color_points=jtf.color_points,
        opacity_points=jtf.opacity_points)


@pytest.mark.parametrize("tfs", [True, False])
def test_reference_state_from_scene_equals_jax(tfs):
    (js, _), (ts, _) = jax_and_port_scenes(ensemble(1), tfs=tfs)
    for scene in (js, ts):
        scene.current_member = 3
    dataset = {"filename": "ensemble.zarr"}
    assert (as_json(state_ref.reference_state_from_scene(ts, dataset))
            == as_json(jax_state_ref.reference_state_from_scene(js,
                                                                dataset)))


def test_save_state_in_the_reference_format_equals_jax(tmp_path):
    (js, _), (ts, _) = jax_and_port_scenes(ensemble(2))
    js.save_state(str(tmp_path / "j.json"), reference_format=True)
    ts.save_state(str(tmp_path / "t.json"), reference_format=True)
    assert ((tmp_path / "t.json").read_text()
            == (tmp_path / "j.json").read_text())


def write_doc(tmp_path, doc, name="ref.json"):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


def test_reference_state_loads_and_renders_like_jax(tmp_path, caplog):
    # The world map's "Shapefile Rasterizer" names no file: the graticule.
    doc = reference_doc(renderers=VIEW_NODES)
    path = write_doc(tmp_path, doc)
    jvd, tvd = volumes(ensemble(3, shape=(12, 1, 16, 20, 24)))
    js = JaxScene.load_state(path, volume_data=jvd)
    with caplog.at_level(logging.WARNING):
        ts = Scene.load_state(path, volume_data=tvd)
    assert any("unmapped setting 'an_unknown_key'" in r.getMessage()
               for r in caplog.records)
    assert ts.renderers == as_json(js.renderers)
    assert ts.window_size == js.window_size == (1280, 720)
    assert ts.current_member == 2 and ts.dock_layout == js.dock_layout
    for tscam, jscam in zip(ts.views, js.views):
        assert tscam.position == jscam.position
    (tname, tcalc), = ts.volume_data.calculators.items()
    jcalc = js.volume_data.calculators[tname]
    assert tcalc.get_settings() == jcalc.get_settings()
    assert tcalc._ref_extra == jcalc._ref_extra
    for name, jtf in js.transfer_functions.items():
        np.testing.assert_allclose(ts.transfer_functions[name].lut.numpy(),
                                   np.asarray(jtf.lut), atol=1e-7, rtol=0)
    for view in (0, 1):
        kw = dict(image_size=IMAGE, show_reference_points=True,
                  show_legend=True)
        want = np.asarray(js.render_view(view, **kw))
        got = ts.render_view(view, **kw).numpy()
        assert np.isfinite(got).all() and np.abs(got - want).max() <= 1e-2
        assert jmetrics.ssim(got, want) >= 0.995
        assert got[..., 3].max() > 0.5


def test_reference_round_trip_through_the_port(tmp_path):
    # A TF read from the widget's XML is written back point for point
    # (a colormap's LUT would be re-interpolated in linear RGB, a LUT-only
    # TF sampled at 17 points, as in JAX).
    (_, _), (ts, name) = jax_and_port_scenes(ensemble(4), tfs=False)
    ts.transfer_functions[name] = tf_from_xml_string(TF_XML, (-1.0, 1.0))
    for r in ts.renderers:
        if r["type"] == "world_map":
            r.pop("shapefile")  # the graticule
    ts.window_size = (640, 360)
    path = str(tmp_path / "ref.json")
    ts.save_state(path, dataset={"filename": "ensemble.zarr"},
                  reference_format=True)
    back = Scene.load_state(path, volume_data=ts.volume_data)
    assert back.window_size == (640, 360)
    for view in (0, 1):
        kw = dict(image_size=IMAGE, show_diagram_overlays=False,
                  show_legend=True, show_reference_points=True)
        got = back.render_view(view, **kw)
        want = ts.render_view(view, **kw)
        assert float((got - want).abs().max()) <= 1e-6
        assert float(got[..., 3].max()) > 0.5


def test_a_reference_state_without_its_dataset_raises(tmp_path):
    doc = reference_doc(renderers=[])
    with pytest.raises(ValueError, match="catalog"):
        Scene.load_state(write_doc(tmp_path, doc), device="cpu")
