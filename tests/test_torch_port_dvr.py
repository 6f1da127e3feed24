"""PyTorch port (correrender_tpu_torch) vs the JAX package: the restricted
and depth-clipped shear-warp frame. Transfer-function control points,
the render restriction, ``classify_volume`` (kernel B3's module),
``prepare_cvol_cf``, ``dvr_shearwarp(classified=, depth_limit=)`` and its
route to the fixed-step marcher for cameras inside the volume's slab.

On the CPU the B3 wrapper runs its plain version; chip_smoke.py holds
the kernel to it on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import correrender_tpu.render.dvr_fast as jdf
from correrender_tpu.ops.pallas.shearwarp_kernel import (
    prepare_cvol_cf as jax_prepare_cvol_cf,
)
from correrender_tpu.render import restriction as jrest
from correrender_tpu.render.camera import Camera as JaxCamera
from correrender_tpu.render.classify import (
    classify_volume as jax_classify_volume,
)
from correrender_tpu.render.tf import TransferFunction as JaxTF
from correrender_tpu.utils import metrics as jmetrics

import correrender_tpu_torch.render.dvr_fast as tdf
from correrender_tpu_torch.interop import (
    camera_from_fields,
    transfer_function_from_arrays,
)
from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.shearwarp_kernel import prepare_cvol_cf
from correrender_tpu_torch.render import restriction as trest
from correrender_tpu_torch.render.camera import default_render_box
from correrender_tpu_torch.render.classify import (
    classify,
    classify_volume,
    classify_volume_plain,
)
from correrender_tpu_torch.render.tf import TransferFunction

SHAPE = (10, 14, 18)  # (Z, Y, X)
IMAGE = (80, 60)
MAX_ABS = 1e-2  # the shear-warp frame bars of tests/test_torch_port_slice.py
MIN_SSIM = 0.995


def _cams(**kw):
    jcam = JaxCamera(**kw)
    return jcam, camera_from_fields(jcam.position, jcam.look_at_point,
                                    jcam.up, jcam.fovy, jcam.z_near,
                                    jcam.z_far)


def _field(seed=7):
    rng = np.random.default_rng(seed)
    field = rng.uniform(-1, 1, size=SHAPE).astype(np.float32)
    field[2, 3, 4] = np.nan
    return field


def _tfs():
    jtf = JaxTF.from_colormap("viridis", domain=(-1, 1),
                              opacity_points=((0.0, 0.6), (1.0, 0.2)))
    return jtf, transfer_function_from_arrays(
        np.asarray(jtf.lut), jtf.domain, color_points=jtf.color_points,
        opacity_points=jtf.opacity_points)


@pytest.mark.parametrize("name,kw", [
    ("coolwarm", dict(domain=(-1, 1),
                      opacity_points=((0.0, 0.8), (0.5, 0.0), (1.0, 0.8)))),
    ("viridis", dict(resolution=64)),
])
def test_from_colormap_keeps_its_control_points(name, kw):
    jtf = JaxTF.from_colormap(name, **kw)
    ttf = TransferFunction.from_colormap(name, **kw)
    np.testing.assert_array_equal(ttf.lut.numpy(), np.asarray(jtf.lut))
    assert ttf.color_points == jtf.color_points
    assert ttf.opacity_points == jtf.opacity_points


def test_from_control_points_matches_jax():
    args = ([(0.0, (0.0, 0.2, 1.0)), (0.3, (0.1, 1.0, 0.1)),
             (1.0, (1.0, 0.1, 0.0))], [(0.0, 0.0), (0.4, 0.3), (1.0, 0.9)])
    jtf = JaxTF.from_control_points(*args, domain=(-2, 3), resolution=128)
    ttf = TransferFunction.from_control_points(*args, domain=(-2, 3),
                                               resolution=128)
    np.testing.assert_array_equal(ttf.lut.numpy(), np.asarray(jtf.lut))
    assert ttf.domain == (-2.0, 3.0)
    assert ttf.color_points == jtf.color_points
    assert ttf.opacity_points == jtf.opacity_points
    lut_only = transfer_function_from_arrays(np.asarray(jtf.lut), jtf.domain)
    assert lut_only.color_points is None and lut_only.opacity_points is None


@pytest.mark.parametrize("ref_point", [(0, 0, 0), (17, 13, 9), (5, 4, 6)])
def test_restriction_center_matches_jax(ref_point):
    box = default_render_box(SHAPE)
    np.testing.assert_array_equal(
        trest.restriction_center(ref_point, SHAPE, box),
        jrest.restriction_center(ref_point, SHAPE, box))


@pytest.mark.parametrize("metric", trest.DISTANCE_METRIC_NAMES)
@pytest.mark.parametrize("radius", [0.05, 0.1, 0.3])
def test_restriction_mask_matches_jax(metric, radius):
    box = default_render_box(SHAPE)
    center = jrest.restriction_center((6, 5, 4), SHAPE, box)
    want = np.asarray(jrest.restriction_mask(SHAPE, box, center, radius,
                                             metric))
    got = trest.restriction_mask(SHAPE, box, center, radius, metric)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size  # the ball cuts the volume


def test_apply_restriction_rgba_matches_jax():
    rng = np.random.default_rng(1)
    rgba = rng.uniform(size=SHAPE + (4,)).astype(np.float32)
    mask = (rng.uniform(size=SHAPE) > 0.5).astype(np.float32)
    want = np.asarray(jrest.apply_restriction_rgba(jnp.asarray(rgba),
                                                   jnp.asarray(mask)))
    got = trest.apply_restriction_rgba(torch.from_numpy(rgba),
                                       torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("domain", [(-1.0, 1.0), (0.0, 0.0), (0.5, -0.5)])
def test_classify_volume_matches_classify_and_jax(domain):
    field = _field() * 1.5
    field[0, 0, :2] = [np.inf, -np.inf]
    lut = np.random.default_rng(3).uniform(size=(64, 4)).astype(np.float32)
    _build.reset_launch_counts()
    got = classify_volume(torch.from_numpy(field), torch.from_numpy(lut),
                          domain)
    assert _build.LAUNCHES["classify_volume"] == 0  # CPU: the plain version
    assert got.shape == SHAPE + (4,) and got.dtype == torch.float32
    # The plain version is the f32 classify, bar 1e-6 (ROADMAP B3).
    want = classify(torch.from_numpy(field), torch.from_numpy(lut), domain)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert torch.equal(got, classify_volume_plain(
        torch.from_numpy(field), torch.from_numpy(lut), domain))
    jwant = np.asarray(jax_classify_volume(jnp.asarray(field),
                                           jnp.asarray(lut), domain))
    np.testing.assert_allclose(got.numpy(), jwant, atol=1e-6, rtol=0)
    assert (got[2, 3, 4] == 0).all()  # NaN → transparent black


def test_classify_volume_refuses_other_devices():
    with pytest.raises(ValueError, match="no classify kernel"):
        classify_volume(torch.zeros(SHAPE, device="meta"),
                        torch.zeros((8, 4), device="meta"), (0.0, 1.0))


def test_prepare_cvol_cf_matches_jax_layout():
    rng = np.random.default_rng(4)
    cvol = rng.uniform(size=(6, 5, 7, 4)).astype(np.float32)
    want = np.asarray(jax_prepare_cvol_cf(jnp.asarray(cvol)).astype(
        jnp.float32))  # (S, 4, Yv_pad, Xv_pad), zero padding
    got = prepare_cvol_cf(torch.from_numpy(cvol))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(
        got.float().permute(0, 3, 1, 2).numpy(), want[:, :, :5, :7])
    assert not want[:, :, 5:].any() and not want[:, :, :, 7:].any()
    with pytest.raises(ValueError, match="expected"):
        prepare_cvol_cf(torch.zeros((6, 5, 7)))


CAMERAS = [
    dict(position=(0.05, 0.3, 0.85)),  # config 1: z axis, flipped
    dict(position=(0.9, 0.15, -0.2)),  # x axis
    dict(position=(0.1, -0.8, 0.3), up=(0.0, 0.0, 1.0)),  # y axis
    dict(position=(-0.2, 0.1, -0.9)),  # z axis, no flip
]


def _restricted(field, restriction, jtf, ttf):
    """The Scene's restricted frame input (app/state.py:494-519) in both
    packages: classify_volume × restriction_mask."""
    box = default_render_box(SHAPE)
    center = jrest.restriction_center(restriction[0], SHAPE, box)
    jcls = jrest.apply_restriction_rgba(
        jax_classify_volume(jnp.asarray(field), jtf.lut,
                            jnp.asarray(jtf.domain, jnp.float32)),
        jrest.restriction_mask(SHAPE, box, center, *restriction[1:]))
    tcls = trest.apply_restriction_rgba(
        classify_volume(torch.from_numpy(field), ttf.lut, ttf.domain),
        trest.restriction_mask(SHAPE, box, center, *restriction[1:]))
    return jcls, tcls


def _depth(seed=5):
    """A depth buffer: a tilted wall through the volume, +inf above it."""
    h, w = IMAGE[1], IMAGE[0]
    d = np.full((h, w), np.inf, np.float32)
    d[h // 3:] = np.linspace(0.75, 0.95, w, dtype=np.float32)[None, :]
    return d


@pytest.mark.parametrize("cam_kw", CAMERAS)
@pytest.mark.parametrize("restriction,clip", [
    (((6, 5, 4), 0.15, "Euclidean"), False),
    (((6, 5, 4), 0.12, "Chebyshev"), True),
    (None, True),
])
def test_restricted_and_clipped_frame_matches_jax(cam_kw, restriction, clip):
    field = _field()
    jcam, tcam = _cams(**cam_kw)
    jtf, ttf = _tfs()
    kw = dict(image_size=IMAGE, intermediate_scale=0.75,
              background=(0.2, 0.1, 0.0, 1.0))
    jkw, tkw = dict(kw), dict(kw)
    if restriction is not None:
        jkw["classified"], tkw["classified"] = _restricted(
            field, restriction, jtf, ttf)
    if clip:
        depth = _depth() - 0.85 + float(np.linalg.norm(cam_kw["position"]))
        jkw["depth_limit"], tkw["depth_limit"] = jnp.asarray(depth), depth
    want = np.asarray(jdf.dvr_shearwarp(jnp.asarray(field), jcam, jtf, **jkw))
    got = tdf.dvr_shearwarp(torch.from_numpy(field), tcam, ttf,
                            **tkw).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= MAX_ABS
    assert jmetrics.ssim(got, want) >= MIN_SSIM
    # The restriction and the clip really cut the frame.
    free = tdf.dvr_shearwarp(torch.from_numpy(field), tcam, ttf,
                             **kw).numpy()
    assert np.abs(got - free).max() > 0.05


@pytest.mark.parametrize("cam_kw", CAMERAS)
def test_depth_to_kstop_matches_jax(cam_kw):
    jcam, tcam = _cams(**cam_kw)
    box = default_render_box(SHAPE)
    depth = _depth() - 0.85 + float(np.linalg.norm(cam_kw["position"]))
    eye, a, in_plane, flip = tdf.shearwarp_axes(tcam)
    perm = tdf.slice_perm(a, in_plane)
    s, nv, nu = (SHAPE[p] for p in perm)
    geo = tdf.shearwarp_geometry(tcam, box[0], box[1], a, in_plane, flip, s,
                                 nv, nu, IMAGE, 0.75)
    want = np.asarray(jdf._depth_to_kstop(
        jnp.asarray(depth), jcam, IMAGE[0], IMAGE[1], in_plane, a, eye,
        geo["z_ref"], geo["grid_u"], geo["grid_v"],
        jnp.asarray(geo["len_factor"].numpy()), geo["slice_coords"], s))
    got = tdf._depth_to_kstop(depth, tcam, IMAGE[0], IMAGE[1], in_plane, a,
                              eye, geo).numpy()
    assert got.shape == (geo["hi_res"], geo["wi_res"])
    # Fractional slice indices: a slab is one unit; f32 rounding of the
    # homography inverse moves them by far less.
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert 0 < (want < s).mean() < 1  # part of the grid is clipped


def test_classified_frame_ignores_the_transfer_function():
    # With classified= the frame comes from the classified volume alone.
    field = _field()
    _, tcam = _cams(**CAMERAS[0])
    _, ttf = _tfs()
    cls = classify_volume(torch.from_numpy(field), ttf.lut, ttf.domain)
    other = TransferFunction.from_colormap("gray")
    a = tdf.dvr_shearwarp(torch.from_numpy(field), tcam, ttf,
                          image_size=IMAGE, classified=cls)
    b = tdf.dvr_shearwarp(torch.from_numpy(field), tcam, other,
                          image_size=IMAGE, classified=cls)
    assert torch.equal(a, b)
    # ...and equals the unrestricted frame, whose K2 rounds the same LUT
    # lerp to bf16.
    c = tdf.dvr_shearwarp(torch.from_numpy(field), tcam, ttf,
                          image_size=IMAGE)
    assert (a - c).abs().max() <= 1e-2


@pytest.mark.parametrize("cam_kw", [
    dict(position=(0.0, 0.0, 0.05), look_at_point=(0.0, 0.0, -1.0)),
    dict(position=(0.05, -0.02, 0.01), look_at_point=(1.0, 0.1, 0.0)),
])
def test_eye_inside_frame_matches_jax(cam_kw):
    field = _field()
    jcam, tcam = _cams(**cam_kw)
    jtf, ttf = _tfs()
    kw = dict(image_size=(48, 32), attenuation=20.0)
    assert not tdf.shearwarp_viable(tcam, default_render_box(SHAPE))
    want = np.asarray(jdf.dvr_shearwarp(jnp.asarray(field), jcam, jtf, **kw))
    got = tdf.dvr_shearwarp(torch.from_numpy(field), tcam, ttf, **kw).numpy()
    # Both render with their fixed-step marcher (render/dvr.py).
    assert np.abs(got - want).max() <= 1e-5
    assert got[..., :3].max() > 0.05
