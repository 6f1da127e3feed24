"""PyTorch port (correrender_tpu_torch) vs the JAX package: camera,
transfer function, classification (K2's module), the shear-warp
compositor (K3's module) and the warp.

On the CPU the K2 and K3 wrappers run their plain versions; the kernels
are held to those on the card by chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import correrender_tpu.render.dvr_fast as jdf
from correrender_tpu.render.camera import (
    Camera as JaxCamera,
    default_render_box as jax_default_render_box,
    look_at as jax_look_at,
    perspective as jax_perspective,
    ray_dirs_affine as jax_ray_dirs_affine,
)
from correrender_tpu.render.classify import (
    classify as jax_classify,
    two_hot_weights as jax_two_hot_weights,
)
from correrender_tpu.render.tf import TransferFunction as JaxTF

import correrender_tpu_torch.render.dvr_fast as tdf
from correrender_tpu_torch.interop import (
    camera_from_fields,
    transfer_function_from_arrays,
)
from correrender_tpu_torch.ops.cuda.shearwarp_kernel import (
    classify_to_cf,
    shearwarp_composite,
    shearwarp_composite_plain,
)
from correrender_tpu_torch.render import camera as tcamera
from correrender_tpu_torch.render.classify import classify, two_hot_weights
from correrender_tpu_torch.render.tf import TransferFunction

CAMERAS = [
    dict(position=(0.05, 0.3, 0.85)),  # config 1: z axis, far → near flip
    dict(position=(0.9, 0.15, -0.2)),  # x axis
    dict(position=(0.1, -0.8, 0.3), up=(0.0, 0.0, 1.0)),  # y axis
    dict(position=(-0.2, 0.1, -0.9), fovy=math.pi / 3),  # z axis, no flip
]


def _cams(kw):
    jcam = JaxCamera(**kw)
    return jcam, camera_from_fields(jcam.position, jcam.look_at_point,
                                    jcam.up, jcam.fovy, jcam.z_near,
                                    jcam.z_far)


def _classify_values():
    rng = np.random.default_rng(0)
    v = rng.uniform(-1.6, 1.6, size=(5, 6, 7)).astype(np.float32)
    v[0, 0, :3] = [np.nan, np.inf, -np.inf]
    v[1, 1, :4] = [-1.0, 1.0, 0.0, -0.3]  # bin edges and the domain ends
    return v


def _lut(resolution=64):
    rng = np.random.default_rng(1)
    return rng.uniform(size=(resolution, 4)).astype(np.float32)


DOMAINS = [(-1.0, 1.0), (0.0, 0.0), (-0.3, 0.7), (0.5, -0.5)]


@pytest.mark.parametrize("domain", DOMAINS)
def test_two_hot_weights_match_jax(domain):
    v = _classify_values()
    got = two_hot_weights(torch.from_numpy(v), domain, 64)
    want = jax_two_hot_weights(jnp.asarray(v),
                               jnp.asarray(domain, jnp.float32), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("premultiply", [True, False])
@pytest.mark.parametrize("domain", DOMAINS)
def test_classify_matches_jax(domain, premultiply):
    v, lut = _classify_values(), _lut()
    got = classify(torch.from_numpy(v), torch.from_numpy(lut), domain,
                   premultiply=premultiply)
    want = jax_classify(jnp.asarray(v), jnp.asarray(lut),
                        jnp.asarray(domain, jnp.float32),
                        premultiply=premultiply)
    assert got.shape == v.shape + (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (got[0, 0, 0] == 0).all()  # NaN → transparent black


@pytest.mark.parametrize("perm,flip", [
    ((0, 1, 2), False), ((0, 1, 2), True), ((1, 0, 2), False),
    ((1, 0, 2), True), ((2, 0, 1), False), ((2, 1, 0), True),
])
@pytest.mark.parametrize("domain", [(-1.0, 1.0), (0.0, 0.0)])
def test_classify_to_cf_orients_and_matches_classify(perm, flip, domain):
    v, lut = torch.from_numpy(_classify_values()), torch.from_numpy(_lut())
    cf = classify_to_cf(v, perm, flip, lut, domain)
    oriented = v.permute(*perm)
    if flip:
        oriented = oriented.flip(0)
    want = classify(oriented, lut, domain)
    assert cf.dtype == torch.bfloat16 and cf.shape == want.shape
    np.testing.assert_allclose(cf.float().numpy(), want.numpy(), atol=4e-3)


def _composite_setup():
    """tests/test_pallas.py:98-118."""
    rng = np.random.default_rng(0)
    s, yv, xv = 20, 24, 40
    hi, wi = 48, 64
    cvol = rng.uniform(size=(s, yv, xv, 4)).astype(np.float32) * 0.3
    arrays = dict(
        g=np.linspace(1.0, 1.8, s).astype(np.float32),
        coords_y=np.linspace(-0.2, 0.2, yv).astype(np.float32),
        coords_x=np.linspace(-0.25, 0.25, xv).astype(np.float32),
        grid_v=np.linspace(-0.22, 0.22, hi).astype(np.float32),
        grid_u=np.linspace(-0.27, 0.27, wi).astype(np.float32),
        eye_uv=np.asarray([0.05, -0.03], np.float32),
        len_factor=(1.0 + 0.2 * rng.uniform(size=(hi, wi))).astype(
            np.float32),
    )
    kstop = rng.uniform(0.0, s, size=(hi, wi)).astype(np.float32)
    return cvol, arrays, kstop, (hi, wi)


@pytest.mark.parametrize("use_kstop", [False, True])
def test_composite_plain_matches_jax_scan(use_kstop):
    cvol, arr, kstop, (hi, wi) = _composite_setup()
    rgb_j, a_j = jdf._composite_scan(
        jnp.asarray(cvol), *(jnp.asarray(arr[k]) for k in (
            "g", "coords_y", "coords_x", "grid_v", "grid_u", "eye_uv",
            "len_factor")),
        jnp.float32(0.02), jnp.float32(80.0), hi=hi, wi=wi,
        kstop=jnp.asarray(kstop) if use_kstop else None,
    )
    cf = torch.from_numpy(cvol).to(torch.bfloat16)
    targs = {k: torch.from_numpy(v) for k, v in arr.items()
             if k != "eye_uv"}
    rgb_t, a_t = shearwarp_composite(
        cf, **targs, eye_uv=tuple(arr["eye_uv"]), slab_thickness=0.02,
        attenuation=80.0,
        kstop=torch.from_numpy(kstop) if use_kstop else None,
    )
    assert rgb_t.shape == (hi, wi, 3) and a_t.shape == (hi, wi)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=3e-3)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=3e-3)
    if use_kstop:  # the clip really cut the march
        rgb_n, a_n = shearwarp_composite_plain(
            cf, **targs, eye_uv=tuple(arr["eye_uv"]), slab_thickness=0.02,
            attenuation=80.0)
        assert (a_n - a_t).max() > 0.05


@pytest.mark.parametrize("cam_kw", CAMERAS)
def test_shearwarp_geometry_matches_jax(cam_kw):
    jcam, tcam = _cams(cam_kw)
    shape = (12, 20, 24)
    box = jax_default_render_box(shape)
    assert jdf.shearwarp_viable(jcam, box) == tdf.shearwarp_viable(tcam, box)
    assert jdf.shearwarp_camera_key(jcam) == tdf.shearwarp_camera_key(tcam)
    _, a, in_plane, flip = tdf.shearwarp_axes(tcam)
    perm = tdf.slice_perm(a, in_plane)
    s, nv, nu = (shape[p] for p in perm)
    args = (box[0], box[1], a, in_plane, flip, s, nv, nu, (96, 64), 0.75)
    want = jdf.shearwarp_geometry(jcam, *args)
    got = tdf.shearwarp_geometry(tcam, *args)
    for key, value in want.items():
        if key == "len_factor":
            np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(value))


def _inter_image(hi, wi, seed=2):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(size=(hi, wi)).astype(np.float32)
    rgb = (rng.uniform(size=(hi, wi, 3)) * alpha[..., None]).astype(
        np.float32)
    return rgb, alpha


# Config 1's camera is held to the 1e-3 bar. Elsewhere a tent weight or
# pass-A value whose f32 coordinate differs in the last bits between
# XLA and PyTorch can round to the neighbouring bf16 value, which moves
# a pixel of this noise image by up to one bf16 ulp below 1.0 (3.9e-3);
# it happens at a few pixels of the y-axis camera.
@pytest.mark.parametrize("cam_kw,atol", [
    (CAMERAS[0], 1e-3), *((c, 4e-3) for c in CAMERAS[1:])])
def test_warp_to_screen_matches_jax(cam_kw, atol):
    jcam, tcam = _cams(cam_kw)
    shape = (12, 20, 24)
    box = jax_default_render_box(shape)
    eye, a, in_plane, flip = tdf.shearwarp_axes(tcam)
    s, nv, nu = (shape[p] for p in tdf.slice_perm(a, in_plane))
    width, height = 96, 64
    geo = jdf.shearwarp_geometry(jcam, box[0], box[1], a, in_plane, flip,
                                 s, nv, nu, (width, height), 0.75)
    rgb, alpha = _inter_image(geo["hi_res"], geo["wi_res"])
    bg = (0.1, 0.2, 0.3, 1.0)
    want = jdf.warp_to_screen(jnp.asarray(rgb), jnp.asarray(alpha), jcam,
                              width, height, in_plane, a, eye, geo["z_ref"],
                              geo["grid_u"], geo["grid_v"], bg)
    got = tdf.warp_to_screen(torch.from_numpy(rgb), torch.from_numpy(alpha),
                             tcam, width, height, in_plane, a, eye,
                             geo["z_ref"], geo["grid_u"], geo["grid_v"], bg)
    assert got.shape == (height, width, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    # Beyond a handful of pixels the two agree to 1e-3 for every camera.
    assert (np.abs(got.numpy() - np.asarray(want)) > 1e-3).mean() < 1e-3


def test_gather_warp_matches_jax():
    jcam, tcam = _cams(CAMERAS[0])
    shape = (12, 20, 24)
    box = jax_default_render_box(shape)
    eye, a, in_plane, flip = tdf.shearwarp_axes(tcam)
    s, nv, nu = (shape[p] for p in tdf.slice_perm(a, in_plane))
    geo = jdf.shearwarp_geometry(jcam, box[0], box[1], a, in_plane, flip,
                                 s, nv, nu, (96, 64), 0.75)
    rgb, alpha = _inter_image(geo["hi_res"], geo["wi_res"])
    bg = (0.0, 0.0, 0.0, 1.0)
    origin, dirs = jcam.rays(96, 64)
    axis = np.eye(3, dtype=np.float32)
    want = jdf._warp(jnp.asarray(rgb), jnp.asarray(alpha),
                     jnp.asarray(geo["grid_u"]), jnp.asarray(geo["grid_v"]),
                     origin, dirs, jnp.asarray(axis[in_plane[0]]),
                     jnp.asarray(axis[in_plane[1]]),
                     jnp.float32(geo["z_ref"]), jnp.asarray(axis[a]),
                     jnp.asarray(bg, jnp.float32))
    got = tdf._gather_warp(torch.from_numpy(rgb), torch.from_numpy(alpha),
                           tcam, 96, 64, in_plane, a, geo["z_ref"],
                           geo["grid_u"], geo["grid_v"], bg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("cam_kw", CAMERAS)
def test_camera_matches_jax(cam_kw):
    jcam, tcam = _cams(cam_kw)
    origin_j, dirs_j = jcam.rays(40, 30)
    origin_t, dirs_t = tcam.rays(40, 30)
    np.testing.assert_allclose(origin_t.numpy(), np.asarray(origin_j),
                               atol=1e-6)
    np.testing.assert_allclose(dirs_t.numpy(), np.asarray(dirs_j), atol=1e-6)
    for got, want in zip(tcamera.ray_dirs_affine(tcam, 40, 30),
                         jax_ray_dirs_affine(jcam, 40, 30)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tcamera.look_at(jcam.position, jcam.look_at_point, jcam.up),
        jax_look_at(jcam.position, jcam.look_at_point, jcam.up))
    np.testing.assert_array_equal(tcamera.perspective(0.7, 1.5, 0.01, 10.0),
                                  jax_perspective(0.7, 1.5, 0.01, 10.0))


@pytest.mark.parametrize("shape", [(12, 20, 24), (1, 5, 3), (250, 250, 250)])
def test_default_render_box_matches_jax(shape):
    for got, want in zip(tcamera.default_render_box(shape),
                         jax_default_render_box(shape)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["gray", "coolwarm", "viridis", "heatmap"])
def test_transfer_function_lut_matches_jax(name):
    kw = dict(domain=(-1, 1), opacity_points=((0.0, 0.8), (0.5, 0.0),
                                              (1.0, 0.8)))
    got = TransferFunction.from_colormap(name, **kw)
    want = JaxTF.from_colormap(name, **kw)
    np.testing.assert_array_equal(got.lut.numpy(), np.asarray(want.lut))
    assert got.domain == tuple(float(d) for d in want.domain)
    via_arrays = transfer_function_from_arrays(np.asarray(want.lut),
                                               want.domain)
    assert torch.equal(via_arrays.lut, got.lut)


def test_transfer_function_from_arrays_rejects_bad_lut():
    with pytest.raises(ValueError):
        transfer_function_from_arrays(np.zeros((8, 3)), (0, 1))


def test_kernel_wrappers_refuse_other_devices():
    lut = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="no classify kernel"):
        classify_to_cf(torch.zeros((2, 2, 2), device="meta"), (0, 1, 2),
                       False, lut, (0.0, 1.0))
    cf = torch.zeros((2, 2, 2, 4), dtype=torch.bfloat16, device="meta")
    meta = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="no composite kernel"):
        shearwarp_composite(cf, meta, meta, meta, meta, meta, (0.0, 0.0),
                            torch.zeros((2, 2), device="meta"), 0.1, 1.0)
