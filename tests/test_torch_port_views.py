"""PyTorch port (correrender_tpu_torch) vs the JAX package: the Scene's
view content besides the volume — ``sample_nearest``, the slice renderer,
the domain outline and line segments, picking and the reference-point
marker, the colour legend, the world map, the 38 named colormaps and the
TF widget's XML — and whole Scene frames with each of them.

The same numpy inputs (drawn from fixed seeds) go to both packages, on
the CPU. Bars: slices 1e-5 where both packages find the plane (at most
0.1% of the pixels may disagree on that, at the plane's rim), with an
outlier allowance explained at ``assert_slice_close``; depth 1e-5; the
outline 1e-5; the marker and the world-map frame 1e-6; the legend, the
graticule, the shapefile raster and the colormap LUTs exact; TF XML
strings identical and LUTs within 1e-7; Scene frames max-abs 1e-2 and
SSIM 0.995 (the Scene tests' bars).
"""

import os
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu.app.state import Scene as JaxScene
from correrender_tpu.calculators.correlation import (
    CorrelationCalculator as JaxCalculator,
)
from correrender_tpu.core.fields import GridMetadata as JaxGrid
from correrender_tpu.core.fields import VolumeData as JaxVolumeData
from correrender_tpu.diagrams import colormaps as jax_colormaps
from correrender_tpu.render import Camera as JaxCamera
from correrender_tpu.render import TransferFunction as JaxTF
from correrender_tpu.render import legend as jax_legend
from correrender_tpu.render import outline as jax_outline
from correrender_tpu.render import picking as jax_picking
from correrender_tpu.render import sampling as jax_sampling
from correrender_tpu.render import slice_renderer as jax_slice
from correrender_tpu.render import tf as jax_tf
from correrender_tpu.render import worldmap as jax_worldmap
from correrender_tpu.utils import metrics as jmetrics

from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.calculators.correlation import (
    CorrelationCalculator,
)
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.diagrams import colormaps
from correrender_tpu_torch.interop import (
    camera_from_fields,
    transfer_function_from_arrays,
)
from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.render import (
    legend,
    outline,
    picking,
    sampling,
    slice_renderer,
    tf,
    worldmap,
)
from correrender_tpu_torch.render.camera import default_render_box
from correrender_tpu_torch.render.tf import TransferFunction

MAX_ABS, MIN_SSIM = 1e-2, 0.995
IMAGE = (96, 64)
GRID = (24, 20, 16)  # (Z, Y, X)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one torch thread (the tier-1 command runs six
    test workers on eight cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tcam(jcam):
    return camera_from_fields(jcam.position, jcam.look_at_point, jcam.up,
                              jcam.fovy, jcam.z_near, jcam.z_far)


def ttf_of(jtf):
    return transfer_function_from_arrays(
        np.asarray(jtf.lut), jtf.domain, color_points=jtf.color_points,
        opacity_points=jtf.opacity_points)


def volume(seed=0, nan=True):
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=GRID).astype(np.float32)
    if nan:
        vol[3, 4, 5] = vol[10, 9, 8] = np.nan
    return vol


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- sampling --------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_sample_nearest_matches_jax(scale):
    vol = volume(1)
    rng = np.random.default_rng(2)
    coords = ((rng.uniform(size=(7, 9, 3)) - 0.5) * scale + 0.5).astype(
        np.float32)
    got = sampling.sample_nearest(torch.from_numpy(vol),
                                  torch.from_numpy(coords))
    want = jax_sampling.sample_nearest(jnp.asarray(vol), jnp.asarray(coords))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- slices ----------------------------------------------------------------

SLICE_CAMERA = (0.3, 0.4, 0.7)
PLANES = {
    "axis z": dict(axis="z", position=0.5),
    "axis x": dict(axis="x", position=0.3),
    "oblique": dict(normal=(1.0, 1.0, 1.0)),
    "oblique, plane_dist": dict(normal=(0.2, 0.3, 1.0), plane_dist=0.02),
}
SLICE_CASES = [
    (plane, light, nan, ground)
    for plane in PLANES for light in (0.0, 0.5)
    for nan in ("ignore", "yellow") for ground in (False, True)
    # A vertical plane has no ground footprint (a ValueError, below).
    if not (ground and plane == "axis x")
]


def assert_slice_close(got, want, got_depth, want_depth):
    """Where both packages find the plane, the frames within 1e-5 on all
    but 0.1% of the pixels and within 4e-5 on every one; the depth within
    1e-5 where both are finite; at most 0.1% of the pixels on which the
    packages disagree about the plane (its rim).

    XLA on the CPU contracts the plane hit, the trilinear lerps and the
    shading into fused multiply-adds where torch rounds each operation,
    and the rays come from two implementations: at the worst pixel of
    the oblique yellow case the two frames differ by 1.5e-5, each about
    7.5e-6 from a float64 evaluation of the same pixel, on either side.
    """
    got, want = np_of(got), np_of(want)
    got_depth, want_depth = np_of(got_depth), np_of(want_depth)
    hit_got, hit_want = np.isfinite(got_depth), np.isfinite(want_depth)
    assert (hit_got != hit_want).mean() <= 1e-3
    agree = hit_got == hit_want
    err = np.abs(got - want).max(axis=-1)[agree]
    assert np.isfinite(got).all() and err.max() <= 4e-5
    assert (err > 1e-5).mean() <= 1e-3
    both = hit_got & hit_want
    np.testing.assert_allclose(got_depth[both], want_depth[both], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("plane,light,nan,ground", SLICE_CASES)
def test_slice_render_3d_matches_jax(plane, light, nan, ground):
    vol = volume(3)
    jcam = JaxCamera(position=SLICE_CAMERA)
    jtf = JaxTF.from_colormap("viridis", domain=(-2, 2),
                              opacity_points=((0.0, 0.3), (1.0, 1.0)))
    kw = dict(PLANES[plane], lighting_factor=light, nan_handling=nan,
              fix_on_ground=ground, image_size=IMAGE, return_depth=True,
              background=(0.1, 0.2, 0.3, 0.5))
    want, want_depth = jax_slice.slice_render_3d(jnp.asarray(vol), jcam, jtf,
                                                 **kw)
    got, got_depth = slice_renderer.slice_render_3d(
        torch.from_numpy(vol), tcam(jcam), ttf_of(jtf), **kw)
    assert got.shape == (IMAGE[1], IMAGE[0], 4)
    assert_slice_close(got, want, got_depth, want_depth)
    assert np.isfinite(got_depth.numpy()).mean() > 0.05


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_slice_image_matches_jax(axis):
    vol = volume(4)
    jtf = JaxTF.from_colormap("coolwarm", domain=(-2, 2))
    want = jax_slice.slice_image(jnp.asarray(vol), jtf, axis=axis,
                                 position=0.4)
    got = slice_renderer.slice_image(torch.from_numpy(vol), ttf_of(jtf),
                                     axis=axis, position=0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    got = slice_renderer.slice_image(torch.from_numpy(vol), ttf_of(jtf),
                                     axis=axis, resolution=(9, 5))
    assert got.shape == (5, 9, 4)


@pytest.mark.parametrize("kw,match", [
    (dict(axis="x", fix_on_ground=True), "z component"),
    (dict(nan_handling="red"), "nan_handling"),
    (dict(normal=(0.0, 0.0, 0.0)), "non-zero"),
])
def test_slice_refuses_what_jax_refuses(kw, match):
    vol = torch.from_numpy(volume(5))
    tf_ = TransferFunction.from_colormap("gray")
    for fn, args in ((slice_renderer.slice_render_3d,
                      (vol, tcam(JaxCamera()), tf_)),
                     (jax_slice.slice_render_3d,
                      (jnp.asarray(vol.numpy()), JaxCamera(),
                       JaxTF.from_colormap("gray")))):
        with pytest.raises(ValueError, match=match):
            fn(*args, image_size=(8, 6), **kw)


# -- outline and segments --------------------------------------------------

OUTLINE_CAMERAS = {
    "outside": (0.35, 0.3, 0.6),
    # Inside the box: corners behind the camera, edges through its plane.
    "plane cuts edges": (0.05, 0.02, 0.1),
}


@pytest.mark.parametrize("camera", list(OUTLINE_CAMERAS))
@pytest.mark.parametrize("layer", [True, False])
def test_outline_matches_jax(camera, layer):
    jcam = JaxCamera(position=OUTLINE_CAMERAS[camera])
    box = default_render_box(GRID)
    base = np.random.default_rng(6).uniform(size=(IMAGE[1], IMAGE[0], 4)
                                            ).astype(np.float32)
    kw = dict(image_size=IMAGE, color=(0.9, 0.8, 0.2, 0.7), line_width=2.0,
              return_depth=True)
    want, want_depth = jax_outline.outline_render(
        jcam, box, base_image=None if layer else jnp.asarray(base), **kw)
    got, got_depth = outline.outline_render(
        tcam(jcam), box, base_image=None if layer else torch.from_numpy(base),
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    want_depth = np.asarray(want_depth)
    np.testing.assert_array_equal(np.isinf(got_depth.numpy()),
                                  np.isinf(want_depth))
    fin = np.isfinite(want_depth)
    assert fin.any()
    np.testing.assert_allclose(got_depth.numpy()[fin], want_depth[fin],
                               atol=1e-5, rtol=0)


def test_segments_and_connecting_line_match_jax():
    boxes = (((-0.2, -0.1, -0.1), (0.0, 0.1, 0.0)),
             ((0.05, -0.1, 0.05), (0.2, 0.1, 0.2)))
    want_pts = jax_outline.connecting_line_points(*boxes)
    got_pts = outline.connecting_line_points(*boxes)
    for g, w in zip(got_pts, want_pts):
        np.testing.assert_array_equal(g, w)
    jcam = JaxCamera(position=(0.3, 0.2, 0.7))
    p0s = np.array([got_pts[0], (-0.2, -0.2, -0.2)], np.float32)
    p1s = np.array([got_pts[1], (0.2, 0.1, 0.0)], np.float32)
    want = jax_outline.segments_render(jcam, p0s, p1s, image_size=IMAGE)
    got = outline.segments_render(tcam(jcam), p0s, p1s, image_size=IMAGE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert got[..., 3].max() > 0.5


# -- picking and the marker ------------------------------------------------

@pytest.mark.parametrize("fixed_z", [None, 0.3])
@pytest.mark.parametrize("pixel", [(48, 32), (10, 50), (95, 0)])
def test_picking_matches_jax(pixel, fixed_z):
    jcam = JaxCamera(position=(0.2, 0.3, 0.6))
    box = default_render_box(GRID)
    args = (pixel, IMAGE)
    assert (picking.pick_voxel(tcam(jcam), *args, GRID, box, fixed_z)
            == jax_picking.pick_voxel(jcam, *args, GRID, box, fixed_z))
    got = picking.pick_hit_points(tcam(jcam), *args, box, fixed_z)
    want = jax_picking.pick_hit_points(jcam, *args, box, fixed_z)
    assert (got is None) == (want is None)
    if want is not None:
        # The rays of the two packages differ in the last bit.
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
        picking.scrub_focus(got, 0.05)
        jax_picking.scrub_focus(want, 0.05)
        np.testing.assert_allclose(got["focus"], want["focus"], atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("position", [(0.2, 0.3, 0.6), (0.0, 0.0, -0.6)])
@pytest.mark.parametrize("with_base", [False, True])
def test_reference_point_marker_matches_jax(position, with_base):
    jcam = JaxCamera(position=position)
    box = default_render_box(GRID)
    point = (5, 12, 20)  # (x, y, z)
    base = np.random.default_rng(7).uniform(size=(IMAGE[1], IMAGE[0], 4)
                                            ).astype(np.float32)
    kw = dict(image_size=IMAGE, radius_px=5.0)
    want = jax_picking.render_reference_point_marker(
        jcam, point, GRID, box, base_image=jnp.asarray(base) if with_base
        else None, **kw)
    got = picking.render_reference_point_marker(
        tcam(jcam), point, GRID, box, base_image=torch.from_numpy(base)
        if with_base else None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert (picking.marker_screen_center(tcam(jcam), point, GRID, box, IMAGE)
            == jax_picking.marker_screen_center(jcam, point, GRID, box,
                                                IMAGE))
    host = picking.overlay_reference_point_marker_np(
        base.copy(), tcam(jcam), point, GRID, box)
    np.testing.assert_array_equal(
        host, jax_picking.overlay_reference_point_marker_np(
            base.copy(), jcam, point, GRID, box))


def test_marker_behind_the_camera_leaves_the_frame():
    # A camera past the box's -z side, looking away from it.
    cam = camera_from_fields((0.0, 0.0, -0.5), (0.0, 0.0, -1.0),
                             (0.0, 1.0, 0.0), np.pi / 4, 0.001, 100.0)
    box = default_render_box(GRID)
    assert picking.marker_screen_center(cam, (8, 8, 12), GRID, box,
                                        IMAGE) is None
    base = torch.rand((IMAGE[1], IMAGE[0], 4))
    out = picking.render_reference_point_marker(
        cam, (8, 8, 12), GRID, box, image_size=IMAGE, base_image=base)
    assert out is base


# -- legend ----------------------------------------------------------------

LEGEND_FRAMES = [(96, 64), (320, 180), (61, 40), (40, 30), (96, 20)]


@pytest.mark.parametrize("size", LEGEND_FRAMES)
@pytest.mark.parametrize("domain", [(-1.0, 1.0), (0.0, 2.5e4), (3e-3, 0.5)])
def test_legend_matches_jax_exactly(size, domain):
    jtf = JaxTF.from_colormap("viridis", domain=domain)
    w, h = size
    image = np.random.default_rng(8).uniform(size=(h, w, 4)).astype(
        np.float32)
    if h < 24:  # the bar is taller than the frame: both packages refuse
        for fn, tf_ in ((jax_legend.color_legend_overlay, jtf),
                        (legend.color_legend_overlay, ttf_of(jtf))):
            with pytest.raises(ValueError):
                fn(image, tf_)
        return
    want = jax_legend.color_legend_overlay(image, jtf)
    np.testing.assert_array_equal(
        legend.color_legend_overlay(image, ttf_of(jtf)), want)
    patch = legend.legend_patch(size, ttf_of(jtf))
    if patch is None:  # the legend is wider than the frame: the host path
        assert w < 64
        return
    got = legend.blend_legend(torch.from_numpy(image), patch)
    np.testing.assert_array_equal(got.numpy(), want)


# -- world map -------------------------------------------------------------

def write_shapefile(path, rings):
    """A polygon (.shp) file of one record a ring, lon/lat degrees."""
    records = b""
    for i, ring in enumerate(rings):
        content = struct.pack("<i", 5) + struct.pack("<4d", -180, -90, 180,
                                                      90)
        content += struct.pack("<2i", 1, len(ring)) + struct.pack("<i", 0)
        content += b"".join(struct.pack("<2d", x, y) for x, y in ring)
        records += struct.pack(">2i", i + 1, len(content) // 2) + content
    header = struct.pack(">i", 9994) + b"\0" * 20
    header += struct.pack(">i", (100 + len(records)) // 2)
    header += struct.pack("<2i", 1000, 5)
    header += struct.pack("<8d", -180, -90, 180, 90, 0, 0, 0, 0)
    path.write_bytes(header + records)


RINGS = [
    [(-45, -30), (60, -30), (60, 40), (-45, 40), (-45, -30)],
    [(-160, 10), (-100, 70), (-60, 20), (-120, -50), (-160, 10)],
    [(100, -60), (170, -60), (135, 10), (100, -60)],
]


def test_graticule_and_shapefile_textures_equal_jax(tmp_path):
    for kw in ({}, dict(width=200, height=90, spacing_deg=10.0)):
        np.testing.assert_array_equal(worldmap.graticule_texture(**kw),
                                      jax_worldmap.graticule_texture(**kw))
    shp = tmp_path / "land.shp"
    write_shapefile(shp, RINGS)
    for got, want in zip(worldmap.read_shapefile_polygons(str(shp)),
                         jax_worldmap.read_shapefile_polygons(str(shp))):
        np.testing.assert_array_equal(got, want)
    for kw in ({}, dict(width=300, height=140)):
        np.testing.assert_array_equal(
            worldmap.rasterize_shapefile(str(shp), **kw),
            jax_worldmap.rasterize_shapefile(str(shp), **kw))


def test_raster_texture_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(9)
    Image.fromarray(rng.integers(0, 255, (60, 120, 3), dtype=np.uint8)
                    ).save(tmp_path / "earth.png")
    kw = dict(lat_range=(-30.0, 45.0), lon_range=(-100.0, 20.0))
    np.testing.assert_array_equal(
        worldmap.load_raster_texture(str(tmp_path / "earth.png"), **kw),
        jax_worldmap.load_raster_texture(str(tmp_path / "earth.png"), **kw))


@pytest.mark.parametrize("texture", ["graticule", "shapefile"])
@pytest.mark.parametrize("with_base", [False, True])
def test_world_map_render_matches_jax(tmp_path, texture, with_base):
    if texture == "shapefile":
        write_shapefile(tmp_path / "land.shp", RINGS)
        tex = jax_worldmap.rasterize_shapefile(str(tmp_path / "land.shp"))
    else:
        tex = jax_worldmap.graticule_texture()
    jcam = JaxCamera(position=(0.2, 0.35, 0.6))
    box = default_render_box(GRID)
    base = np.random.default_rng(10).uniform(size=(IMAGE[1], IMAGE[0], 4)
                                             ).astype(np.float32)
    base[..., 3] *= base[..., 3] > 0.4  # transparent holes
    kw = dict(texture=tex, plane_height=float(box[0][1]) - 0.01,
              image_size=IMAGE, box=box)
    want = jax_worldmap.world_map_render(
        jcam, base_image=jnp.asarray(base) if with_base else None, **kw)
    got = worldmap.world_map_render(
        tcam(jcam), base_image=torch.from_numpy(base) if with_base else None,
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert (got[..., 3] > 0).float().mean() > 0.1


# -- colormaps and the TF XML ----------------------------------------------

@pytest.mark.parametrize("name", list(jax_colormaps.COLOR_MAP_NAMES))
def test_named_colormap_luts_equal_jax(name):
    kw = dict(domain=(-1.5, 2.0), opacity_points=((0.0, 0.2), (0.6, 0.9),
                                                  (1.0, 0.4)))
    want = JaxTF.from_colormap(name, **kw)
    for spelling in (name, name.upper().replace(" ", "_")):
        got = TransferFunction.from_colormap(spelling, **kw)
        np.testing.assert_array_equal(got.lut.numpy(), np.asarray(want.lut))
        assert got.color_points == want.color_points
    np.testing.assert_array_equal(colormaps.colormap_lut(name, 64),
                                  jax_colormaps.colormap_lut(name, 64))
    assert colormaps.display_name(name.lower()) == name


def test_colormap_names_and_unknowns_follow_jax():
    assert colormaps.all_names() == jax_colormaps.all_names()
    assert len(colormaps.COLOR_MAP_NAMES) == 38
    with pytest.raises(KeyError):
        TransferFunction.from_colormap("no such map")
    got = TransferFunction.constant_opacity("Cividis", (0, 4), alpha=0.3)
    want = JaxTF.constant_opacity("Cividis", (0, 4), alpha=0.3)
    np.testing.assert_array_equal(got.lut.numpy(), np.asarray(want.lut))


def tf_xml(color_data, colorspace):
    scale = {"ushort": 65535, "ubyte": 255}[color_data]
    colors = "".join(
        f'<ColorPoint position="{p}" r="{round(r * scale)}" '
        f'g="{round(g * scale)}" b="{round(b * scale)}"/>'
        for p, (r, g, b) in ((1.0, (1.0, 0.25, 0.0)),
                             (0.0, (0.0, 0.5, 1.0)),
                             (0.35, (0.9, 0.9, 0.1))))
    return (f'<TransferFunction colorspace="sRGB" '
            f'interpolation_colorspace="{colorspace}"><OpacityPoints>'
            '<OpacityPoint position="0" opacity="1"/>'
            '<OpacityPoint position="0.4" opacity="0"/>'
            '<OpacityPoint position="1" opacity="0.5"/></OpacityPoints>'
            f'<ColorPoints color_data="{color_data}">{colors}</ColorPoints>'
            '</TransferFunction>\x00')


@pytest.mark.parametrize("colorspace", ["Linear RGB", "sRGB"])
@pytest.mark.parametrize("color_data", ["ushort", "ubyte"])
def test_tf_xml_round_trip_equals_jax(color_data, colorspace):
    text = tf_xml(color_data, colorspace)
    want = jax_tf.tf_from_xml_string(text, domain=(-2.0, 3.0))
    got = tf.tf_from_xml_string(text, domain=(-2.0, 3.0))
    np.testing.assert_allclose(got.lut.numpy(), np.asarray(want.lut),
                               atol=1e-7, rtol=0)
    assert got.domain == tuple(want.domain)
    assert tf.tf_to_xml_string(got) == jax_tf.tf_to_xml_string(want)
    if colorspace == "Linear RGB":  # the colour space the XML is written in
        again = tf.tf_from_xml_string(tf.tf_to_xml_string(got), got.domain)
        np.testing.assert_allclose(again.lut.numpy(), got.lut.numpy(),
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("num_points", [17, 5])
def test_lut_only_tf_xml_equals_jax(num_points):
    lut = np.random.default_rng(11).uniform(size=(32, 4)).astype(np.float32)
    want = jax_tf.tf_to_xml_string(JaxTF(lut=jnp.asarray(lut)), num_points)
    got = tf.tf_to_xml_string(transfer_function_from_arrays(lut, (0, 1)),
                              num_points)
    assert got == want


def test_xml_refusals_follow_jax():
    with pytest.raises(ValueError, match="root"):
        tf.tf_from_xml_string("<Other/>")
    with pytest.raises(ValueError, match="color_data"):
        tf.tf_from_xml_string(tf_xml("ushort", "sRGB").replace(
            'color_data="ushort"', 'color_data="half"'))
    empty = tf.tf_from_xml_string("<TransferFunction/>")
    want = jax_tf.tf_from_xml_string("<TransferFunction/>")
    np.testing.assert_allclose(empty.lut.numpy(), np.asarray(want.lut),
                               atol=1e-7, rtol=0)


def test_control_points_in_linear_rgb_equal_jax():
    pts = [(0.0, (0.0, 0.5, 1.0)), (0.3, (0.7, 0.1, 0.2)),
           (1.0, (1.0, 0.25, 0.0))]
    opacity = [(0.0, 1.0), (1.0, 0.2)]
    for linear in (False, True):
        got = TransferFunction.from_control_points(
            pts, opacity, interpolate_linear_rgb=linear)
        want = JaxTF.from_control_points(pts, opacity,
                                         interpolate_linear_rgb=linear)
        np.testing.assert_array_equal(got.lut.numpy(), np.asarray(want.lut))
    np.testing.assert_array_equal(tf._srgb_to_linear([0.01, 0.5, 1.0]),
                                  jax_tf._srgb_to_linear([0.01, 0.5, 1.0]))
    np.testing.assert_array_equal(
        tf._linear_to_srgb([0.001, 0.5, 1.0]),
        jax_tf._linear_to_srgb([0.001, 0.5, 1.0]))


def test_transfer_function_call_matches_jax():
    jtf = JaxTF.from_colormap("heatmap", domain=(-1, 1))
    x = np.array([-3.0, -1.0, -0.3, 0.0, 0.7, 1.0, 4.0, np.nan], np.float32)
    np.testing.assert_allclose(ttf_of(jtf)(torch.from_numpy(x)).numpy(),
                               np.asarray(jtf(jnp.asarray(x))), atol=1e-7,
                               rtol=0)


# -- whole Scene frames ----------------------------------------------------

SCENE_GRID, SCENE_MEMBERS = (32, 24, 16), 12  # (xs, ys, zs)
REF_POINT = (10, 8, 6)


@pytest.fixture(scope="module")
def scene_data():
    rng = np.random.default_rng(12)
    xs, ys, zs = SCENE_GRID
    z, y, x = np.meshgrid(*(np.linspace(-1, 1, n) for n in (zs, ys, xs)),
                          indexing="ij")
    base = np.sin(3 * x) * np.cos(2 * y) + z
    data = np.stack([base * (1 + 0.3 * rng.normal()) + 0.4 * rng.normal(
        size=base.shape) for _ in range(SCENE_MEMBERS)])
    return data.astype(np.float32)[:, None]  # (E, T=1, Z, Y, X)


def scenes(data, renderers, camera=(0.25, 0.3, 0.7)):
    """The same Scene on both sides: a Pearson calculator at REF_POINT,
    the renderers, a coolwarm TF."""
    es, ts, zs, ys, xs = data.shape
    grid = dict(xs=xs, ys=ys, zs=zs, ts=ts, es=es)
    jvd, tvd = JaxVolumeData(JaxGrid(**grid)), VolumeData(
        GridMetadata(**grid), device="cpu")
    jcam = JaxCamera(position=camera)
    jtf = JaxTF.from_colormap("coolwarm", domain=(-1, 1),
                              opacity_points=((0.0, 0.6), (0.5, 0.0),
                                              (1.0, 0.6)))
    out = []
    for vd, scene_cls, calc_cls, cam, tf_ in (
            (jvd, JaxScene, JaxCalculator, jcam, jtf),
            (tvd, Scene, CorrelationCalculator, tcam(jcam), ttf_of(jtf))):
        vd.add_field("q", lambda t, e: data[e, t])
        scene = scene_cls(vd, [cam])
        name = scene.add_calculator(calc_cls(field_name="q",
                                             reference_point=REF_POINT))
        for type_id, settings in renderers:
            scene.add_renderer(type_id, field=name, **settings)
        scene.transfer_functions[name] = tf_
        out.append(scene)
    return out


OBLIQUE = ("slice", dict(normal_x=1.0, normal_y=1.0, normal_z=1.0,
                         lighting_factor=0.5, nan_handling="yellow",
                         fix_on_ground=True))
AXIS = ("slice", dict(axis="z", position=0.5))
SCENE_CASES = {
    "slice axis": ([AXIS], {}),
    "slice oblique": ([OBLIQUE], {}),
    "domain_outline": ([("domain_outline", {})], {}),
    "world_map graticule": ([("world_map", {})], {}),
    "world_map shapefile": ([("world_map", {"shapefile": "land.shp"})], {}),
    "reference points": ([("dvr", {})], dict(show_reference_points=True)),
    "legend": ([("dvr", {})], dict(show_legend=True)),
    # Narrower than the legend: the host function draws it.
    "legend, 40x30": ([("dvr", {})], dict(show_legend=True,
                                          image_size=(40, 30))),
    "slice + dvr (K3 kstop)": ([AXIS, ("dvr", {})], {}),
    "outline + dvr": ([("domain_outline", {}), ("dvr", {})], {}),
    "everything": ([("world_map", {}), AXIS, OBLIQUE,
                    ("domain_outline", {}), ("dvr", {})],
                   dict(show_reference_points=True, show_legend=True)),
}


@pytest.mark.parametrize("case", list(SCENE_CASES))
def test_scene_view_content_matches_jax(scene_data, case, tmp_path):
    renderers, kw = SCENE_CASES[case]
    kw = dict(kw, image_size=kw.get("image_size", IMAGE))
    write_shapefile(tmp_path / "land.shp", RINGS)
    renderers = [(t, {k: str(tmp_path / v) if k == "shapefile" else v
                      for k, v in s.items()}) for t, s in renderers]
    js, ts = scenes(scene_data, renderers)
    want = np.asarray(js.render_view(0, **kw))
    got = ts.render_view(0, **kw).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= MAX_ABS
    assert jmetrics.ssim(got, want) >= MIN_SSIM
    assert got[..., 3].max() > 0.2


def test_scene_dvr_stops_at_the_slice(scene_data, monkeypatch):
    # The slice's depth reaches the DVR as K3's stop slices: the frame is
    # the slice layer over the DVR clipped at the slice's depth.
    from correrender_tpu_torch.app.state import _composite
    from correrender_tpu_torch.render import dvr_fast

    _, ts = scenes(scene_data, [AXIS, ("dvr", {})])
    got = ts.render_view(0, image_size=IMAGE)
    vd, name = ts.volume_data, ts.volume_data.field_names[-1]
    box = vd.grid.render_box()
    field = vd.get_field(name)
    img, depth = slice_renderer.slice_render_3d(
        field, ts.views[0], ts.tf_for(name), image_size=IMAGE, box=box,
        background=(0, 0, 0, 0), return_depth=True)
    clipped = dvr_fast.dvr_shearwarp(field, ts.views[0], ts.tf_for(name),
                                     image_size=IMAGE, box=box,
                                     background=(0, 0, 0, 0),
                                     depth_limit=depth)
    assert torch.equal(got, _composite(img, clipped))
    unclipped = dvr_fast.dvr_shearwarp(field, ts.views[0], ts.tf_for(name),
                                       image_size=IMAGE, box=box,
                                       background=(0, 0, 0, 0))
    assert not torch.equal(clipped, unclipped)


def test_scene_caches_textures_and_the_legend(scene_data, tmp_path,
                                              monkeypatch):
    from correrender_tpu_torch.app import state

    write_shapefile(tmp_path / "land.shp", RINGS)
    _, ts = scenes(scene_data, [("world_map", {"shapefile": str(
        tmp_path / "land.shp")}), ("world_map", {}), ("dvr", {})])
    calls = []
    for fn in ("rasterize_shapefile", "graticule_texture", "legend_patch"):
        real = getattr(state, fn)
        monkeypatch.setattr(state, fn, lambda *a, _r=real, _n=fn, **k: (
            calls.append(_n), _r(*a, **k))[1])
    first = ts.render_view(0, image_size=IMAGE, show_legend=True)
    second = ts.render_view(0, image_size=IMAGE, show_legend=True)
    assert torch.equal(first, second)
    assert sorted(calls) == ["graticule_texture", "legend_patch",
                             "rasterize_shapefile"]
    write_shapefile(tmp_path / "land.shp", RINGS[:1])  # a new file version
    stat = os.stat(tmp_path / "land.shp")
    os.utime(tmp_path / "land.shp", ns=(stat.st_atime_ns,
                                        stat.st_mtime_ns + 10**9))
    ts.render_view(0, image_size=(48, 32), show_legend=True)
    assert calls.count("rasterize_shapefile") == 2
    assert calls.count("legend_patch") == 2


def test_scene_view_content_counts_no_launch_on_the_cpu(scene_data):
    _build.reset_launch_counts()
    _, ts = scenes(scene_data, [AXIS, OBLIQUE, ("domain_outline", {}),
                                ("world_map", {}), ("dvr", {})])
    img = ts.render_view(0, image_size=(48, 32), show_legend=True,
                         show_reference_points=True)
    assert img.shape == (32, 48, 4)
    assert not any(_build.LAUNCHES.values())

