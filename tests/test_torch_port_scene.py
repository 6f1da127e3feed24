"""PyTorch port (correrender_tpu_torch) vs the JAX package: the Scene
slice — ``CorrelationCalculator``, ``Scene.render_view``'s DVR and iso
branches (and slices beside DVR at config 1's size; the other view
content is in ``test_torch_port_views.py``), ``render/iso_fast.py``,
state files, camera paths and the flythrough, and BASELINE config 4.

The same numpy inputs (drawn from fixed seeds) go to both packages; on
the CPU every kernel wrapper of the port runs its plain version, and
chip_smoke.py holds the kernels to those on the card. Bars: the
measures' bars of the other ``test_torch_port_*`` files (Pearson 2e-5,
Spearman 2e-6, Kendall 1e-6, MI 1e-5); frames max-abs 1e-2 and SSIM
0.995 (``test_torch_port_slice.py``'s frame bars).
"""

import contextlib
import json
import os
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu.app.camera_path import keyframe_path as jax_keyframe_path
from correrender_tpu.app.camera_path import orbit_path as jax_orbit_path
from correrender_tpu.app.state import Scene as JaxScene
from correrender_tpu.calculators.correlation import (
    CorrelationCalculator as JaxCalculator,
)
from correrender_tpu.core.fields import GridMetadata as JaxGrid
from correrender_tpu.core.fields import VolumeData as JaxVolumeData
from correrender_tpu.io import load_volume as jax_load_volume
from correrender_tpu.render import Camera as JaxCamera
from correrender_tpu.render import TransferFunction as JaxTF
from correrender_tpu.render import iso_fast as jax_iso_fast
from correrender_tpu.render import raymarch_exact as jax_raymarch_exact
from correrender_tpu.utils import fixtures as jfixtures
from correrender_tpu.utils import metrics as jmetrics

from correrender_tpu_torch.app import camera_path
from correrender_tpu_torch.app.baseline_configs import (
    config1_camera,
    config1_transfer_function,
    config4_timelag_zarr_flythrough,
)
from correrender_tpu_torch.app.camera_path import (
    encode_png,
    frame_to_uint8,
    keyframe_path,
    orbit_path,
    render_flythrough,
)
from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.calculators.base import calculator_from_settings
from correrender_tpu_torch.calculators.correlation import (
    CorrelationCalculator,
)
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.interop import (
    camera_from_fields,
    transfer_function_from_arrays,
)
from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.render import dvr_fast, iso_fast
from correrender_tpu_torch.render.camera import Camera, orbit_camera
from correrender_tpu_torch.render.raymarch_exact import dvr_render_exact
from correrender_tpu_torch.render.tf import TransferFunction

ATOL = {"pearson": 2e-5, "spearman": 2e-6, "kendall": 1e-6,
        "mi_binned": 1e-5, "mi_kraskov": 1e-5,
        "binned_mi_correlation_coefficient": 1e-5,
        "kmi_correlation_coefficient": 1e-5}
MAX_ABS = 1e-2
MIN_SSIM = 0.995
CONFIG1_GRID, CONFIG1_MEMBERS = (128, 128, 32), 100  # (xs, ys, zs)
CONFIG1_IMAGE = (1280, 720)
SCENE_IMAGE = (320, 180)  # the other branches: a quarter of each side
REF_POINT = (16, 16, 16)  # the centre of the first planted box


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one torch thread. Its plain marchers and the
    fast iso scan are many small operations a frame, and under the tier-1
    command (six test workers on eight cores) eight-thread regions wait on
    each other: a frame that takes 2 s alone took 40 s there. Yields the
    thread count it replaced, for the few tests of large operations."""
    saved = torch.get_num_threads()
    with torch_threads(1):
        yield saved


def tcam(jcam):
    return camera_from_fields(jcam.position, jcam.look_at_point, jcam.up,
                              jcam.fovy, jcam.z_near, jcam.z_far)


def ttf_of(jtf):
    return transfer_function_from_arrays(
        np.asarray(jtf.lut), jtf.domain, color_points=jtf.color_points,
        opacity_points=jtf.opacity_points)


@contextlib.contextmanager
def torch_threads(n: int):
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def assert_frames_match(got, want, max_abs=MAX_ABS):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= max_abs
    assert jmetrics.ssim(got, want) >= MIN_SSIM


# -- volumes on both sides -------------------------------------------------

def ensemble(seed=0, shape=(10, 8, 4, 5, 6)):
    """(E, T, Z, Y, X) float32 with a shared signal, so fields are not
    pure noise."""
    rng = np.random.default_rng(seed)
    e, t, z, y, x = shape
    base = rng.normal(size=(t, z, y, x))
    data = np.stack([np.roll(base, k, axis=0) + 0.5 * rng.normal(
        size=base.shape) for k in range(e)])
    return data.astype(np.float32)


def volumes(fields: dict, device="cpu"):
    """A JAX and a port VolumeData serving the same (E, T, Z, Y, X)
    arrays per name."""
    first = next(iter(fields.values()))
    es, ts, zs, ys, xs = first.shape
    grid = dict(xs=xs, ys=ys, zs=zs, ts=ts, es=es)
    jvd = JaxVolumeData(JaxGrid(**grid))
    tvd = VolumeData(GridMetadata(**grid), device=device)
    for name, data in fields.items():
        jvd.add_field(name, lambda t, e, d=data: d[e, t])
        tvd.add_field(name, lambda t, e, d=data: d[e, t])
    return jvd, tvd


def calculators(**kw):
    return JaxCalculator(**kw), CorrelationCalculator(**kw)


def field_pair(fields, t=1, e=2, **kw):
    jvd, tvd = volumes(fields)
    jc, tc = calculators(**kw)
    jvd.add_calculator(jc)
    tvd.add_calculator(tc)
    return (np.asarray(jvd.get_field(jc.output_name, t, e)),
            tvd.get_field(tc.output_name, t, e).numpy())


def assert_field_close(got, want, atol):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# -- CorrelationCalculator -------------------------------------------------

@pytest.mark.parametrize("measure", list(ATOL))
@pytest.mark.parametrize("ensemble_mode", [True, False])
def test_calculator_matches_jax(measure, ensemble_mode):
    got_want = field_pair({"q": ensemble()}, field_name="q", measure=measure,
                          reference_point=(2, 3, 1),
                          ensemble_mode=ensemble_mode)
    assert_field_close(got_want[1], got_want[0], ATOL[measure])


@pytest.mark.parametrize("lag", [2, -2, 7, -7])
@pytest.mark.parametrize("measure", ["pearson", "spearman", "mi_binned"])
def test_time_lag_matches_jax(lag, measure):
    want, got = field_pair({"q": ensemble(1)}, field_name="q",
                           measure=measure, reference_point=(4, 0, 2),
                           ensemble_mode=False, time_lag=lag)
    assert_field_close(got, want, ATOL[measure])


@pytest.mark.parametrize("lag", [2, -2])
def test_time_lag_window_reaches_the_kernel_contiguous(lag, monkeypatch):
    # The window stack[..., :T - lag] flattens to a strided view; the
    # kernels take contiguous series only (K1's tiled regime needs an
    # aligned base), so correlate_field copies it once.
    from correrender_tpu_torch.calculators import correlation

    seen = []
    pearson_cuda = correlation.pearson_cuda
    monkeypatch.setattr(correlation, "pearson_cuda", lambda s, r: (
        seen.append((s.is_contiguous(), r.is_contiguous(), s.shape))
        or pearson_cuda(s, r)))
    _, tvd = volumes({"q": ensemble(1)})
    calc = CorrelationCalculator(field_name="q", ensemble_mode=False,
                                 time_lag=lag)
    tvd.add_calculator(calc)
    tvd.get_field(calc.output_name)
    assert seen == [(True, True, (4 * 5 * 6, 8 - abs(lag)))]


def test_time_lag_past_the_series_raises():
    _, tvd = volumes({"q": ensemble(1)})
    calc = CorrelationCalculator(field_name="q", ensemble_mode=False,
                                 time_lag=8)
    tvd.add_calculator(calc)
    with pytest.raises(ValueError, match="time_lag 8"):
        tvd.get_field(calc.output_name)


@pytest.mark.parametrize("measure", ["pearson", "kendall", "mi_binned"])
def test_use_time_lag_correlations_matches_jax(measure):
    fields = {"q": ensemble(2), "r": ensemble(3)}
    want, got = field_pair(fields, t=5, field_name="q", field_name_ref="r",
                           measure=measure, reference_point=(1, 1, 1),
                           use_time_lag_correlations=True,
                           time_lag_time_step_idx=2)
    assert_field_close(got, want, ATOL[measure])


@pytest.mark.parametrize("measure", list(ATOL))
@pytest.mark.parametrize("ensemble_mode", [True, False])
def test_symmetric_fields_match_jax(measure, ensemble_mode):
    fields = {"q": ensemble(4), "r": ensemble(5)}
    want, got = field_pair(fields, field_name="q", field_name_ref="r",
                           measure=measure, symmetric_fields=True,
                           ensemble_mode=ensemble_mode)
    assert_field_close(got, want, ATOL[measure])


@pytest.mark.parametrize("measure", ["pearson", "mi_binned", "kendall"])
def test_absolute_matches_jax(measure):
    want, got = field_pair({"q": ensemble(6)}, field_name="q",
                           measure=measure, absolute=True, num_bins=7,
                           reference_point=(5, 4, 3))
    assert (got >= 0).all()
    assert_field_close(got, want, ATOL[measure])


def test_binned_mi_takes_the_global_bounds():
    data = ensemble(7)
    data[3] *= 4.0  # one member widens the global range
    jvd, tvd = volumes({"q": data})
    calc = CorrelationCalculator(field_name="q", measure="mi_binned",
                                 num_bins=9)
    tvd.add_calculator(calc)
    calls = []
    get_min_max = tvd.get_min_max
    tvd.get_min_max = lambda *a: calls.append(a) or get_min_max(*a)
    got = tvd.get_field(calc.output_name, 1, 0)
    # One host read a member slab (the two reads of the same field share
    # the min/max cache).
    assert len({c for c in calls}) == data.shape[0]
    jc = JaxCalculator(field_name="q", measure="mi_binned", num_bins=9)
    jvd.add_calculator(jc)
    assert_field_close(got.numpy(),
                       np.asarray(jvd.get_field(jc.output_name, 1, 0)),
                       ATOL["mi_binned"])


def test_bfloat16_stack_is_upcast_once():
    jvd, tvd = volumes({"q": ensemble(8)})
    tvd.member_stack_dtype = torch.bfloat16
    jvd.member_stack_dtype = jnp.bfloat16
    jc, tc = calculators(field_name="q", reference_point=(1, 2, 3))
    jvd.add_calculator(jc)
    tvd.add_calculator(tc)
    assert tvd.get_member_stack("q").dtype == torch.bfloat16
    assert_field_close(tvd.get_field(tc.output_name).numpy(),
                       np.asarray(jvd.get_field(jc.output_name)),
                       ATOL["pearson"])


SETTINGS_CASES = [
    dict(),
    dict(field_name="q", measure="kendall", reference_point=(1, 2, 3),
         absolute=True),
    dict(field_name="q", field_name_ref="r", measure="mi_kraskov", k=5,
         kraskov_estimator=2),
    dict(field_name="q", field_name_ref="r", symmetric_fields=True,
         measure="mi_binned", num_bins=17),
    dict(field_name="q", ensemble_mode=False, time_lag=-3),
    dict(field_name="q", use_time_lag_correlations=True,
         time_lag_time_step_idx=4, use_render_restriction=True,
         render_restriction_radius=0.2,
         render_restriction_metric="Chebyshev"),
]


@pytest.mark.parametrize("kw", SETTINGS_CASES)
def test_settings_round_trip_equals_jax(kw):
    jc, tc = calculators(**kw)
    settings = tc.get_settings()
    assert settings == jc.get_settings()
    assert tc.output_name == jc.output_name
    assert (CorrelationCalculator.from_settings(settings).get_settings()
            == JaxCalculator.from_settings(settings).get_settings()
            == settings)
    again = calculator_from_settings(
        "correlation", dict(settings, continuous_recompute=True))
    assert again.get_settings() == settings and again.continuous_recompute


def test_set_reference_point_marks_the_field_dirty():
    _, tvd = volumes({"q": ensemble(9)})
    calc = CorrelationCalculator(field_name="q")
    name = Scene(tvd).add_calculator(calc)
    first = tvd.get_field(name).clone()
    epoch = tvd.dirty_epoch(name)
    calc.set_reference_point(3, 2, 1)
    assert tvd.dirty_epoch(name) == epoch + 1
    assert not torch.equal(tvd.get_field(name), first)


# -- Scene.render_view at config 1's grid ----------------------------------

@pytest.fixture(scope="module")
def config1_data():
    xs, ys, zs = CONFIG1_GRID
    data = jfixtures.synth_box_ensemble(xs=xs, ys=ys, zs=zs,
                                        members=CONFIG1_MEMBERS)
    return data.astype(np.float32)[:, None]  # (E, T=1, Z, Y, X)


def scenes(data, renderers, camera=(0.05, 0.3, 0.85), restricted=False,
           tf=True):
    """The same Scene on both sides: config 1's camera, a Pearson
    calculator at REF_POINT, the renderers, and config 1's TF."""
    jvd, tvd = volumes({"q": data})
    jcam = JaxCamera(position=camera)
    out = []
    for vd, scene_cls, calc_cls, cam in ((jvd, JaxScene, JaxCalculator,
                                          jcam),
                                         (tvd, Scene, CorrelationCalculator,
                                          tcam(jcam))):
        scene = scene_cls(vd, [cam])
        name = scene.add_calculator(calc_cls(
            field_name="q", reference_point=REF_POINT,
            use_render_restriction=restricted,
            render_restriction_radius=0.1))
        for type_id, settings in renderers:
            scene.add_renderer(type_id, field=name, **settings)
        out.append((scene, name))
    if tf:
        jtf = JaxTF.from_colormap(
            "coolwarm", domain=(-1, 1),
            opacity_points=((0.0, 0.8), (0.5, 0.0), (1.0, 0.8)))
        out[0][0].transfer_functions[out[0][1]] = jtf
        out[1][0].transfer_functions[out[1][1]] = ttf_of(jtf)
    return out


def render_both(pair, image_size=SCENE_IMAGE, **kw):
    (js, _), (ts, _) = pair
    return (ts.render_view(0, image_size=image_size, **kw),
            np.asarray(js.render_view(0, image_size=image_size, **kw)))


def test_scene_dvr_matches_jax_at_config1(config1_data, one_torch_thread):
    # The 1280x720 warp is a few large products: every torch thread.
    with torch_threads(one_torch_thread):
        got, want = render_both(scenes(config1_data, [("dvr", {})]),
                                image_size=CONFIG1_IMAGE)
    assert_frames_match(got, want)
    assert got[..., 3].max() > 0.5


CLOSE = dict(camera=(0.02, 0.05, 0.5), image_size=(96, 54))
ISO = ("iso_ray", {"iso_value": 0.5})
ISO_EXACT = ("iso_ray", {"iso_value": 0.5, "quality": "exact"})
ISO_EXACT_2 = ("iso_ray", {"iso_value": 0.3, "quality": "exact",
                           "color": (0.2, 0.5, 0.9, 1.0)})
SCENE_CASES = {
    "dvr restricted": ([("dvr", {})], dict(restricted=True)),
    "dvr default tf": ([("dvr", {})], dict(tf=False)),
    # The exact DVR frames at 96x54, from a closer camera that JAX's
    # plan takes at that size: its interpret-mode marcher and B5's plain
    # march are the slowest frames of the file.
    "dvr exact": ([("dvr", {"quality": "exact"})], CLOSE),
    "dvr exact restricted": ([("dvr", {"quality": "exact"})],
                             dict(CLOSE, restricted=True)),
    "dvr step 0.2": ([("dvr", {"step_size": 0.2})], CLOSE),
    "iso_ray fast": ([ISO], {}),
    "iso_ray fast, axial 1": ([("iso_ray", {"iso_value": 0.5,
                                            "axial_supersample": 1})], {}),
    "iso_ray exact": ([ISO_EXACT], {}),
    "iso_ray exact restricted": ([ISO_EXACT], dict(restricted=True)),
    "iso_raster": ([("iso_raster", {"iso_value": 0.5})], {}),
    "iso_ray exact + dvr": ([ISO_EXACT, ("dvr", {})], {}),
    "two iso + dvr": ([ISO_EXACT, ISO_EXACT_2, ("dvr", {})], {}),
    "eye inside": ([("dvr", {}), ISO], dict(camera=(0.1, 0.05, 0.02))),
    # A slice's depth is a plane: K3's stop slice falls on most rays.
    "slice + dvr": ([("slice", {"axis": "z", "position": 0.5}),
                     ("dvr", {})], {}),
    "oblique slice + outline + dvr": (
        [("slice", dict(normal_x=1.0, normal_y=1.0, normal_z=1.0,
                        lighting_factor=0.5, nan_handling="yellow",
                        fix_on_ground=True)),
         ("domain_outline", {}), ("dvr", {})], {}),
    "empty view": ([], {}),
}


@pytest.mark.parametrize("case", list(SCENE_CASES))
def test_scene_branch_matches_jax(config1_data, case, monkeypatch):
    # On the CPU, JAX's exact marchers run in Pallas interpret mode only
    # up to 3 M samples, and render bigger frames with their fixed-step
    # twins. Raised here, so both Scenes run the plane-order marchers.
    monkeypatch.setattr(jax_raymarch_exact, "_INTERPRET_MAX_SAMPLES",
                        10**9)
    renderers, kw = SCENE_CASES[case]
    kw = dict(kw)
    image_size = kw.pop("image_size", SCENE_IMAGE)
    got, want = render_both(scenes(config1_data, renderers, **kw),
                            image_size=image_size)
    assert_frames_match(got, want)
    if renderers:
        assert got[..., 3].max() > 0.5


def test_scene_restricted_iso_takes_the_exact_marcher(config1_data,
                                                      monkeypatch):
    # The restriction fills the slab with NaN outside the ball, and the
    # fast iso renderer's tent products multiply every slab value (0 · NaN
    # is NaN), so no crossing survives: JAX's Scene draws nothing there
    # (ROADMAP C, a reference fault). The port's Scene sends a restricted
    # iso frame to the exact marcher, which reads NaN as no crossing, and
    # draws JAX's exact restricted frame.
    monkeypatch.setattr(jax_raymarch_exact, "_INTERPRET_MAX_SAMPLES",
                        10**9)
    (js, _), (ts, _) = scenes(config1_data, [ISO], restricted=True)
    got = ts.render_view(0, image_size=SCENE_IMAGE)
    assert np.abs(np.asarray(js.render_view(0, image_size=SCENE_IMAGE))
                  ).max() == 0.0
    for scene in (js, ts):
        scene.renderers[0]["quality"] = "exact"
    assert torch.equal(got, ts.render_view(0, image_size=SCENE_IMAGE))
    assert_frames_match(got, np.asarray(js.render_view(
        0, image_size=SCENE_IMAGE)))
    assert got[..., 3].max() > 0.5


def test_scene_fast_iso_clips_the_dvr(config1_data):
    # The fast iso depth is warped as a bf16 image, so a one-ulp
    # difference of a slab value moves it by up to a slice, and a DVR
    # clipped there differs from JAX's by up to a slice's alpha at the
    # silhouette. The iso layer and its depth are held to JAX's; the
    # frame to the iso layer over the DVR clipped at the port's depth.
    pair = scenes(config1_data, [ISO, ("dvr", {})])
    (js, jname), (ts, name) = pair
    got = ts.render_view(0, image_size=SCENE_IMAGE)
    vd, box = ts.volume_data, ts.volume_data.grid.render_box()
    field = vd.get_field(name)
    iso_kw = dict(image_size=SCENE_IMAGE, box=box, background=(0, 0, 0, 0),
                  axial_supersample=2, return_depth=True)
    img, depth = iso_fast.iso_shearwarp(field, ts.views[0], 0.5, **iso_kw)
    jimg, jdepth = jax_iso_fast.iso_shearwarp(
        js.volume_data.get_field(jname), js.views[0], 0.5, **iso_kw)
    assert_frames_match(img, jimg)
    jdepth = np.asarray(jdepth)
    assert np.array_equal(np.isinf(depth.numpy()), np.isinf(jdepth))
    fin = np.isfinite(jdepth)
    # Within one bf16 step of the depth (2^-8 of [0.5, 1)).
    np.testing.assert_allclose(depth.numpy()[fin], jdepth[fin],
                               atol=2.0**-8, rtol=0)
    from correrender_tpu_torch.app.state import _composite

    dvr = dvr_fast.dvr_shearwarp(field, ts.views[0], ts.tf_for(name),
                                 image_size=SCENE_IMAGE, box=box,
                                 background=(0, 0, 0, 0), depth_limit=depth)
    assert torch.equal(got, _composite(img, dvr))


def test_scene_exact_dvr_is_the_exact_marcher(config1_data):
    (_, _), (ts, name) = scenes(config1_data, [("dvr", {"quality": "exact"})])
    got = ts.render_view(0, image_size=SCENE_IMAGE)
    vd = ts.volume_data
    want = dvr_render_exact(vd.get_field(name), ts.views[0], ts.tf_for(name),
                            image_size=SCENE_IMAGE, box=vd.grid.render_box(),
                            background=(0, 0, 0, 0))
    assert torch.equal(got, want)


def test_scene_layouts_are_reused(config1_data, monkeypatch):
    (_, _), (ts, name) = scenes(config1_data, [("dvr", {})])
    calls = []
    prepare = dvr_fast.prepare_shearwarp
    monkeypatch.setattr("correrender_tpu_torch.app.state.prepare_shearwarp",
                        lambda *a, **k: calls.append(1) or prepare(*a, **k))
    ts.render_view(0, image_size=(64, 36))
    ts.views[0] = Camera(position=(0.1, 0.25, 0.8))  # same principal axis
    ts.render_view(0, image_size=(64, 36))
    assert len(calls) == 1
    ts.transfer_functions[name] = config1_transfer_function("cpu")  # new uid
    ts.render_view(0, image_size=(64, 36))
    assert len(calls) == 2
    ts.volume_data.calculators[name].set_reference_point(10, 10, 10)
    ts.render_view(0, image_size=(64, 36))
    assert len(calls) == 3
    for _ in range(Scene._PREPARED_CACHE_CAP + 2):
        ts.transfer_functions[name] = config1_transfer_function("cpu")
        ts.render_view(0, image_size=(64, 36))
    assert len(ts._prepared_cache) == Scene._PREPARED_CACHE_CAP


def test_exact_layout_is_not_keyed_on_the_restriction(config1_data):
    (_, _), (ts, name) = scenes(config1_data,
                                [("iso_ray", {"iso_value": 0.5,
                                              "quality": "exact"}),
                                 ("dvr", {"quality": "exact"})])
    ts.render_view(0, image_size=(48, 27))
    calc = ts.volume_data.calculators[name]
    calc.use_render_restriction = True
    for radius in (0.1, 0.2):
        calc.render_restriction_radius = radius
        ts.render_view(0, image_size=(48, 27))
    keys = [k for k in ts._prepared_cache if k[0] == "exact_march"]
    assert keys == [("exact_march", name, 0, 0,
                     ts.volume_data.dirty_epoch(name))]


def test_depth_merge_and_composite_match_jax():
    from correrender_tpu.app.state import _composite as jax_composite
    from correrender_tpu.app.state import _depth_merge as jax_depth_merge
    from correrender_tpu_torch.app.state import _composite, _depth_merge

    rng = np.random.default_rng(11)
    layers = []
    for _ in range(3):
        rgba = rng.uniform(0, 1, (6, 7, 4)).astype(np.float32)
        depth = rng.uniform(0, 2, (6, 7)).astype(np.float32)
        depth[rng.uniform(size=(6, 7)) < 0.3] = np.inf
        layers.append((rgba, depth))
    for n in (1, 2, 3):
        want = jax_depth_merge([(jnp.asarray(a), jnp.asarray(d))
                                for a, d in layers[:n]])
        got = _depth_merge([(torch.from_numpy(a), torch.from_numpy(d))
                            for a, d in layers[:n]])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    base, over = layers[0][0], layers[1][0]
    np.testing.assert_allclose(
        _composite(torch.from_numpy(base), torch.from_numpy(over)).numpy(),
        np.asarray(jax_composite(jnp.asarray(base), jnp.asarray(over))),
        atol=1e-7, rtol=0)
    assert _depth_merge([]) == (None, None)


def test_unported_view_content_raises():
    # Diagram overlays are the only view content the port cannot draw
    # yet; the view elements ported since are held to JAX in
    # tests/test_torch_port_views.py.
    _, tvd = volumes({"q": ensemble(10)})
    scene = Scene(tvd)
    scene.add_renderer("diagram", field="q")
    with pytest.raises(NotImplementedError, match="A.10"):
        scene.render_view(0, image_size=(16, 12))


def test_diagram_nodes_render_without_overlays():
    _, tvd = volumes({"q": ensemble(10)})
    scene = Scene(tvd)
    scene.add_renderer("scatter_plot", field="q")
    img = scene.render_view(0, image_size=(16, 12),
                            show_diagram_overlays=False)
    assert img.shape == (12, 16, 4) and float(img.abs().max()) == 0.0


def test_camera_checkpoints_and_unknown_renderer():
    _, tvd = volumes({"q": ensemble(10)})
    scene = Scene(tvd)
    scene.views[0] = Camera(position=(0.3, 0.2, 0.9))
    scene.save_camera_checkpoint("a")
    scene.views[0] = Camera()
    scene.restore_camera_checkpoint("a")
    assert scene.views[0].position == (0.3, 0.2, 0.9)
    with pytest.raises(KeyError):
        scene.restore_camera_checkpoint("b")
    with pytest.raises(ValueError):
        scene.add_renderer("nope")


# -- render/iso_fast.py ----------------------------------------------------

ISO_CAMERAS = [
    dict(position=(0.05, 0.3, 0.85)),  # z, flip
    dict(position=(-0.2, 0.1, -0.9)),  # z
    dict(position=(0.9, 0.15, -0.2)),  # x, flip
    dict(position=(0.1, -0.8, 0.3), up=(0.0, 0.0, 1.0)),  # y
]


@pytest.mark.parametrize("cam_kw", ISO_CAMERAS)
@pytest.mark.parametrize("refine,ss", [(0, 1), (0, 2), (2, 1)])
def test_iso_shearwarp_matches_jax(cam_kw, refine, ss):
    rng = np.random.default_rng(12)
    zs, ys, xs = 10, 14, 18
    z, y, x = np.meshgrid(np.linspace(-1, 1, zs), np.linspace(-1, 1, ys),
                          np.linspace(-1, 1, xs), indexing="ij")
    field = (np.sqrt(x * x + y * y + z * z)
             + 0.05 * rng.normal(size=x.shape)).astype(np.float32)
    jcam = JaxCamera(**cam_kw)
    kw = dict(image_size=(72, 48), background=(0.1, 0.1, 0.1, 1.0),
              refine=refine, axial_supersample=ss, return_depth=True)
    jprep = jax_iso_fast.prepare_iso_shearwarp(jnp.asarray(field), jcam,
                                               axial_supersample=ss)
    tprep = iso_fast.prepare_iso_shearwarp(torch.from_numpy(field),
                                           tcam(jcam), axial_supersample=ss)
    assert tprep["key"] == jprep["key"]
    np.testing.assert_allclose(tprep["cvol"].numpy(),
                               np.asarray(jprep["cvol"]), atol=1e-5,
                               rtol=1e-6)
    want, want_d = jax_iso_fast.iso_shearwarp(jnp.asarray(field), jcam, 0.6,
                                              prepared=jprep, **kw)
    got, got_d = iso_fast.iso_shearwarp(torch.from_numpy(field), tcam(jcam),
                                        0.6, prepared=tprep, **kw)
    assert_frames_match(got, want)
    want_d = np.asarray(want_d)
    assert np.array_equal(np.isinf(got_d.numpy()), np.isinf(want_d))
    fin = np.isfinite(want_d)
    assert fin.mean() > 0.02
    np.testing.assert_allclose(got_d.numpy()[fin], want_d[fin], atol=1e-3,
                               rtol=0)


def test_iso_scan_rows_are_independent():
    rng = np.random.default_rng(13)
    field = torch.from_numpy(rng.normal(size=(8, 9, 11)).astype(np.float32))
    cam = Camera(position=(0.05, 0.3, 0.85))
    prep = iso_fast.prepare_iso_shearwarp(field, cam, axial_supersample=2)
    box_min, box_max = (np.asarray(b, np.float32)
                        for b in dvr_fast.default_render_box(field.shape))
    eye, a, in_plane, flip = dvr_fast.shearwarp_axes(cam)
    geo = dvr_fast.shearwarp_geometry(cam, box_min, box_max, a, in_plane,
                                      flip, prep["n_base"], 9, 11, (40, 30),
                                      1.0)
    g = geo["g"][0] + np.arange(prep["cvol"].shape[0]) * (
        (geo["g"][1] - geo["g"][0]) / 2)
    rest = (geo["grid_u"], (geo["e_u"], geo["e_v"]), 0.1)
    head = (prep["cvol"], g, geo["coords_v"], geo["coords_u"])
    full = iso_fast.first_hit_scan(*head, geo["grid_v"], *rest)
    rows = torch.arange(0, len(geo["grid_v"]), 7)
    part = iso_fast.first_hit_scan(
        *head, np.asarray(geo["grid_v"])[rows.numpy()], *rest)
    for f, p in zip(full, part):
        assert torch.equal(f[rows], p)


# -- state files -----------------------------------------------------------

def state_scene(scene_cls, calc_cls, cam_cls, tf_cls, vd):
    scene = scene_cls(vd, [cam_cls(position=(0.05, 0.3, 0.85))])
    name = scene.add_calculator(calc_cls(
        field_name="q", measure="spearman", reference_point=(2, 1, 3),
        use_render_restriction=True, render_restriction_radius=0.3))
    scene.add_renderer("dvr", field=name, attenuation=50.0)
    scene.add_renderer("iso_ray", field=name, iso_value=0.4,
                       color=(0.1, 0.2, 0.3, 1.0))
    scene.transfer_functions[name] = tf_cls.from_colormap(
        "viridis", domain=(-1, 1), opacity_points=((0.0, 0.5), (1.0, 0.1)))
    scene.current_member = 1
    scene.camera_checkpoints["side"] = cam_cls(position=(0.9, 0.1, 0.1))
    scene.dock_layout = [[0]]
    return scene


def jax_frame_drawn_exact(js, image_size):
    """JAX's frame with its iso renderers on the exact marcher: the
    port's Scene draws a restricted iso frame so (see
    test_scene_restricted_iso_takes_the_exact_marcher)."""
    saved = [dict(r) for r in js.renderers]
    for r in js.renderers:
        if r["type"] == "iso_ray":
            r["quality"] = "exact"
    try:
        return np.asarray(js.render_view(0, image_size=image_size))
    finally:
        js.renderers[:] = saved


def test_save_state_equals_jax(tmp_path):
    jvd, tvd = volumes({"q": ensemble(14)})
    state_scene(JaxScene, JaxCalculator, JaxCamera, JaxTF, jvd).save_state(
        str(tmp_path / "j.json"), dataset={"filename": "x.zarr"})
    state_scene(Scene, CorrelationCalculator, Camera, TransferFunction,
                tvd).save_state(str(tmp_path / "t.json"),
                                dataset={"filename": "x.zarr"})
    assert (json.loads((tmp_path / "t.json").read_text())
            == json.loads((tmp_path / "j.json").read_text()))


def test_jax_state_loads_and_renders_the_same(tmp_path):
    jvd, tvd = volumes({"q": ensemble(15)})
    js = state_scene(JaxScene, JaxCalculator, JaxCamera, JaxTF, jvd)
    js.save_state(str(tmp_path / "j.json"))
    ts = Scene.load_state(str(tmp_path / "j.json"), volume_data=tvd)
    assert ts.current_member == 1 and ts.dock_layout == [[0]]
    assert ts.camera_checkpoints["side"].position == (0.9, 0.1, 0.1)
    assert ts.renderers == json.loads(
        (tmp_path / "j.json").read_text())["renderers"]
    got = ts.render_view(0, image_size=(48, 36))
    assert_frames_match(got, jax_frame_drawn_exact(js, (48, 36)))


def test_state_with_its_dataset_loads(tmp_path):
    from correrender_tpu.app.baseline_configs import (
        _write_zarr_array as jax_write_zarr_array,
    )

    data = ensemble(16)
    jax_write_zarr_array(str(tmp_path / "s.zarr" / "q"), data,
                         (2, 4, 4, 5, 6))
    jvd = jax_load_volume(str(tmp_path / "s.zarr"))
    js = state_scene(JaxScene, JaxCalculator, JaxCamera, JaxTF, jvd)
    js.save_state(str(tmp_path / "j.json"),
                  dataset={"filename": str(tmp_path / "s.zarr")})
    ts = Scene.load_state(str(tmp_path / "j.json"), device="cpu")
    assert ts.volume_data.device.type == "cpu"
    assert_frames_match(ts.render_view(0, image_size=(40, 30)),
                        jax_frame_drawn_exact(js, (40, 30)))


def test_tf_dict_round_trip_equals_jax():
    jtf = JaxTF.from_colormap("heatmap", domain=(-2, 3),
                              opacity_points=((0.0, 0.1), (0.4, 0.9),
                                              (1.0, 0.0)))
    ttf = ttf_of(jtf)
    assert ttf.to_dict() == jtf.to_dict()
    back = TransferFunction.from_dict(jtf.to_dict())
    np.testing.assert_array_equal(back.lut.numpy(), np.asarray(jtf.lut))
    assert back.uid != ttf.uid and back.color_points == jtf.color_points
    points_only = {k: v for k, v in jtf.to_dict().items() if k != "lut"}
    np.testing.assert_array_equal(
        TransferFunction.from_dict(points_only).lut.numpy(),
        np.asarray(JaxTF.from_dict(points_only).lut))


# -- camera paths, PNGs and the flythrough ---------------------------------

def cam_fields(c):
    return (tuple(np.float64(v) for v in c.position),
            tuple(np.float64(v) for v in c.look_at_point),
            tuple(c.up), c.fovy)


@pytest.mark.parametrize("n", [1, 4, 9])
def test_orbit_and_keyframe_paths_equal_jax(n):
    assert ([cam_fields(c) for c in orbit_path(n)]
            == [cam_fields(c) for c in jax_orbit_path(n)])
    from correrender_tpu.render.camera import (
        orbit_camera as jax_orbit_camera,
    )

    assert (cam_fields(orbit_camera(0.3 * n, 0.2, 1.5, (0.1, 0, 0)))
            == cam_fields(jax_orbit_camera(0.3 * n, 0.2, 1.5, (0.1, 0, 0))))
    keys = [(0.1, 0.2, 0.9), (0.8, 0.1, 0.1), (0.0, -0.7, 0.3),
            (-0.6, 0.2, -0.5)]
    jk = [JaxCamera(position=p, look_at_point=(0.01 * i, 0, 0))
          for i, p in enumerate(keys)]
    tk = [tcam(c) for c in jk]
    for m in (1, 2, 3, 4):
        assert ([cam_fields(c) for c in keyframe_path(tk[:m], n)]
                == [cam_fields(c) for c in jax_keyframe_path(jk[:m], n)])


def decode_png(data: bytes) -> np.ndarray:
    """A minimal decoder of the encoder's PNGs (8-bit, filter 0 rows)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        crc = int.from_bytes(data[pos + 8 + length:pos + 12 + length], "big")
        assert crc == zlib.crc32(kind + payload) & 0xFFFFFFFF
        if kind == b"IHDR":
            header = payload
        elif kind == b"IDAT":
            idat += payload
        pos += 12 + length
    w, h = (int.from_bytes(header[i:i + 4], "big") for i in (0, 4))
    channels = {0: 1, 2: 3, 6: 4}[header[9]]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * channels)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, channels)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("shape", [(13, 17), (1, 1), (240, 320)])
def test_png_decodes_to_the_frame_pixels(channels, shape):
    rng = np.random.default_rng(18)
    frame = rng.uniform(-0.2, 1.2, shape + (channels,)).astype(np.float32)
    pixels = frame_to_uint8(torch.from_numpy(frame))
    data = encode_png(pixels)
    np.testing.assert_array_equal(decode_png(data), pixels)
    try:
        from PIL import Image
    except ImportError:
        return
    import io

    img = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(img.reshape(pixels.shape), pixels)


class _CountingScene:
    """Wraps a Scene: counts frames rendered and not yet fetched."""

    def __init__(self, scene, monkeypatch):
        self.scene = scene
        self.views = scene.views
        self.in_flight = 0
        self.most = 0
        self.times = []
        write = camera_path.write_png

        def counted_write(path, img):
            self.in_flight -= 1
            write(path, img)

        monkeypatch.setattr(camera_path, "write_png", counted_write)

    @property
    def current_time(self):
        return self.scene.current_time

    @current_time.setter
    def current_time(self, t):
        self.times.append(t)
        self.scene.current_time = t

    def render_view(self, view, image_size):
        self.in_flight += 1
        self.most = max(self.most, self.in_flight)
        return self.scene.render_view(view, image_size=image_size)


@pytest.mark.parametrize("bound", [1, 2, 3])
def test_flythrough_keeps_its_in_flight_bound(tmp_path, monkeypatch, bound):
    _, tvd = volumes({"q": ensemble(19)})
    scene = Scene(tvd)
    name = scene.add_calculator(CorrelationCalculator(
        field_name="q", ensemble_mode=False, time_lag=1))
    scene.add_renderer("dvr", field=name)
    counting = _CountingScene(scene, monkeypatch)
    monkeypatch.setattr(camera_path, "MAX_IN_FLIGHT", bound)
    files = render_flythrough(counting, orbit_path(7), str(tmp_path),
                              image_size=(24, 16), time_indices=[0, 3, 5])
    assert counting.most == bound and counting.in_flight == 0
    assert counting.times == [0, 3, 5, 0, 3, 5, 0]
    assert [os.path.basename(f) for f in files] == [
        f"frame_{i:04d}.png" for i in range(7)]
    scene.current_time = 5
    scene.views[0] = orbit_path(7)[6]
    last = decode_png(open(files[-1], "rb").read())
    np.testing.assert_array_equal(
        last, frame_to_uint8(scene.render_view(0, image_size=(24, 16))))


def test_config4_frames_match_jax(tmp_path):
    res = config4_timelag_zarr_flythrough(str(tmp_path / "port"),
                                          device="cpu")
    assert res["frames"] and len(res["frames"]) == 4
    # The JAX package's config 4 scene on the same store.
    jvd = jax_load_volume(str(tmp_path / "port" / "ens.zarr"))
    js = JaxScene(jvd)
    name = js.add_calculator(JaxCalculator(
        field_name="q", measure="pearson", reference_point=(12, 12, 6),
        ensemble_mode=False, time_lag=2))
    js.add_renderer("dvr", field=name)
    ts = res["scene"]
    for i, cam in enumerate(res["cameras"]):
        t = res["times"][i % len(res["times"])]
        ts.views[0], ts.current_time = cam, t
        js.views[0] = JaxCamera(position=cam.position,
                                look_at_point=cam.look_at_point)
        js.current_time = t
        assert_frames_match(ts.render_view(0, image_size=(320, 240)),
                            js.render_view(0, image_size=(320, 240)))


def test_config4_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config4_timelag_zarr_flythrough(str(tmp_path))


def test_scene_paths_never_count_a_launch_on_the_cpu(config1_data):
    _build.reset_launch_counts()
    pair = scenes(config1_data[:12], [("iso_ray", {"iso_value": 0.5}),
                                      ("dvr", {})], restricted=True)
    pair[1][0].render_view(0, image_size=(32, 18))
    assert not any(_build.LAUNCHES.values())
    assert config1_camera().position == (0.05, 0.3, 0.85)
