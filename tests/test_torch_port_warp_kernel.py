"""PyTorch port (correrender_tpu_torch): a model of the arithmetic of the
homography warp kernel (``csrc/warp.cu``), held on the CPU to its plain
version, ``warp_two_pass_plain``.

The plain version is held to the JAX package through
``warp_to_screen`` by ``test_warp_to_screen_matches_jax``; the CUDA
kernel runs only on the card, where chip_smoke.py holds it to the plain
version. These tests hold what the kernel computes, pixel by pixel, to
the plain version's answer, bit for bit: the intermediate read through
its strides, each pass's two taps and bf16 tent weights, the bf16 pass-A
value, the sign mask, the alpha clamp and the background blend.
"""

import numpy as np
import pytest
import torch

import correrender_tpu_torch.render.dvr_fast as tdf
from correrender_tpu_torch.ops.cuda.warp_kernel import (
    _tent,
    variant_coeffs,
    warp_two_pass_plain,
)
from correrender_tpu_torch.render.camera import Camera, default_render_box
from test_torch_port_shearwarp import CAMERAS, _inter_image

F = np.float32
VARIANTS = [(False, False), (False, True), (True, False), (True, True)]
WIDTH, HEIGHT = 96, 64

# -- the kernel, as csrc/warp.cu runs it -------------------------------------


def bf16(x):
    """``round_bf16``: f32 → nearest-even bf16, as ``__float2bfloat16_rn``."""
    x = np.asarray(x, F)
    b = x.view(np.uint32)
    r = ((b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) >> 16) << 16
    return np.where(np.isnan(x), x, r.astype(np.uint32).view(F))


def safe(den):
    return np.where(np.abs(den) < F(1e-12), F(1e-12), den)


def tent(coord, tap):
    w = F(1.0) - np.abs(coord - tap.astype(F))
    return bf16(np.where(w < F(0.0), F(0.0), w))


def first_tap(coord, taps):
    t = np.floor(np.where(np.isnan(coord), F(-2.0), coord))
    return np.minimum(np.maximum(t, F(-2.0)), F(taps)).astype(np.int64)


def strided(t):
    """A tensor's whole storage as flat f32, with its offset and strides:
    what the kernel is handed."""
    n = t.untyped_storage().nbytes() // 4
    return (t.as_strided((n,), (1,), 0).numpy(), t.storage_offset(),
            t.stride())


def warp_model(rgb, alpha, coeffs, sign_ok, background, t_int, t_out,
               width, height):
    """``homography_warp_kernel`` over every screen pixel at once."""
    (a0, a1, a2), (b0, b1, b2), (c0, c1, c2) = (
        [F(v) for v in x] for x in variant_coeffs(coeffs, t_int, t_out))
    bg = np.asarray(background, F)
    rgb_flat, rgb_off, (rs0, rs1, rs2) = strided(rgb)
    a_flat, a_off, (as0, as1) = strided(alpha)
    hi, wi = alpha.shape
    rgb_row, rgb_col, a_row, a_col = rs0, rs1, as0, as1
    if t_int:  # correrender_warp swaps the intermediate's axes
        hi, wi = wi, hi
        rgb_row, rgb_col, a_row, a_col = rs1, rs0, as1, as0
    sy, sx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    px = (sy if t_out else sx).astype(F)
    py = (sx if t_out else sy).astype(F)

    with np.errstate(all="ignore"):
        cpa = c0 + c1 * px
        bpa = b0 + b1 * px
        apa = a0 + a1 * px
        den_full = cpa + c2 * py
        sv = (bpa + b2 * py) / safe(den_full)
        s = np.zeros((height, width, 4), F)
        r0 = first_tap(sv, hi)
        for dr in (0, 1):
            r = r0 + dr
            row_in = (r >= 0) & (r <= hi - 1)
            y = r.astype(F)
            num = y * cpa - bpa
            den = b2 - y * c2
            py_star = num / safe(den)
            u_den = cpa + c2 * py_star
            u = (apa + a2 * py_star) / safe(u_den)
            t = np.zeros((height, width, 4), F)
            j0 = first_tap(u, wi)
            for dj in (0, 1):
                j = j0 + dj
                inside = row_in & (j >= 0) & (j <= wi - 1)
                rr, jj = np.where(inside, r, 0), np.where(inside, j, 0)
                w = tent(u, j)
                at = rgb_off + rr * rgb_row + jj * rgb_col
                vals = np.stack(
                    [rgb_flat[at], rgb_flat[at + rs2], rgb_flat[at + 2 * rs2],
                     a_flat[a_off + rr * a_row + jj * a_col]], axis=-1)
                t = np.where(inside[..., None], t + w[..., None] * bf16(vals),
                             t)
            wb = tent(sv, r)
            s = np.where(row_in[..., None], s + wb[..., None] * bf16(t), s)

        valid = np.where(den_full * F(sign_ok) > F(0.0), F(1.0), F(0.0))
        a = s[..., 3] * valid
        a = np.where(a < F(0.0), F(0.0), np.where(a > F(1.0), F(1.0), a))
        behind = (F(1.0) - a) * bg[3]
        a_out = a + behind
        keep = np.where(a_out < F(1e-6), F(1e-6), a_out)
        rgb_out = (s[..., :3] * valid[..., None]
                   + behind[..., None] * bg[:3]) / keep[..., None]
    return np.concatenate([rgb_out, a_out[..., None]], axis=-1)


# -- inputs ------------------------------------------------------------------


def _geometry(cam_kw):
    """A camera's shear-warp axes and intermediate grid at 96×64 (scale
    0.75) over a 12×20×24 volume."""
    cam = Camera(**cam_kw)
    shape = (12, 20, 24)
    box = default_render_box(shape)
    eye, a, in_plane, flip = tdf.shearwarp_axes(cam)
    s, nv, nu = (shape[p] for p in tdf.slice_perm(a, in_plane))
    geo = tdf.shearwarp_geometry(cam, box[0], box[1], a, in_plane, flip,
                                 s, nv, nu, (WIDTH, HEIGHT), 0.75)
    return cam, eye, a, in_plane, geo


def _setup(cam_kw, seed=2):
    """A noise image on a camera's intermediate grid, the homography and
    the sign of a forward ray's denominator."""
    cam, eye, a, in_plane, geo = _geometry(cam_kw)
    rgb, alpha = _inter_image(geo["hi_res"], geo["wi_res"], seed)
    coeffs, sign_ok, _ = tdf.warp_args(cam, WIDTH, HEIGHT, in_plane, a, eye,
                                       geo["z_ref"], geo["grid_u"],
                                       geo["grid_v"], *alpha.shape)
    return torch.from_numpy(rgb), torch.from_numpy(alpha), coeffs, sign_ok


def _check(rgb, alpha, coeffs, sign_ok, background, t_int, t_out,
           plain_inputs=None):
    """The model against the plain version (on ``plain_inputs`` if given:
    the same values in other strides); returns the frame."""
    got = warp_model(rgb, alpha, coeffs, sign_ok, background, t_int, t_out,
                     WIDTH, HEIGHT)
    p_rgb, p_alpha = plain_inputs or (rgb, alpha)
    want = warp_two_pass_plain(p_rgb, p_alpha, coeffs, sign_ok, background,
                               t_int, t_out, WIDTH, HEIGHT).numpy()
    assert got.shape == want.shape == (HEIGHT, WIDTH, 4)
    np.testing.assert_array_equal(got, want)
    return got


BG = (0.1, 0.2, 0.3, 1.0)


@pytest.mark.parametrize("t_int,t_out", VARIANTS)
@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_model_matches_plain_each_camera_and_variant(cam, t_int, t_out):
    rgb, alpha, coeffs, sign_ok = _setup(CAMERAS[cam])
    got = _check(rgb, alpha, coeffs, sign_ok, BG, t_int, t_out)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_warp_to_screen_runs_the_order_it_scores(cam):
    """On the CPU warp_to_screen is the plain version of the pass order
    ``pass_order`` picks."""
    camera, eye, a, in_plane, geo = _geometry(CAMERAS[cam])
    rgb, alpha, coeffs, sign_ok = _setup(CAMERAS[cam])
    got = tdf.warp_to_screen(rgb, alpha, camera, WIDTH, HEIGHT, in_plane, a,
                             eye, geo["z_ref"], geo["grid_u"], geo["grid_v"],
                             BG)
    order = tdf.pass_order(coeffs, *alpha.shape)
    want = warp_model(rgb, alpha, coeffs, sign_ok, BG, *order, WIDTH, HEIGHT)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t_int,t_out", VARIANTS)
def test_model_reads_a_transposed_intermediate(t_int, t_out):
    """The intermediate as transposed views of (Wi, Hi) storage: the
    kernel walks its strides, the plain gets a contiguous copy."""
    rgb, alpha, coeffs, sign_ok = _setup(CAMERAS[1])
    rgb_t = rgb.transpose(0, 1).contiguous().transpose(0, 1)
    alpha_t = alpha.transpose(0, 1).contiguous().transpose(0, 1)
    assert not rgb_t.is_contiguous() and rgb_t.stride(1) > rgb_t.stride(0)
    _check(rgb_t, alpha_t, coeffs, sign_ok, BG, t_int, t_out,
           plain_inputs=(rgb, alpha))


def test_model_reads_channel_strides_and_an_offset():
    """rgb every other channel of a wider array, alpha a column of it,
    both at an offset into their storage."""
    rgb, alpha, coeffs, sign_ok = _setup(CAMERAS[2])
    hi, wi = alpha.shape
    wide = torch.zeros((hi, wi, 7))
    wide[..., 1:7:2] = rgb
    wide[..., 6] = alpha
    rgb_s, alpha_s = wide[..., 1:7:2], wide[..., 6]
    assert rgb_s.stride(2) == 2 and alpha_s.storage_offset() == 6
    _check(rgb_s, alpha_s, coeffs, sign_ok, BG, False, False,
           plain_inputs=(rgb, alpha))


@pytest.mark.parametrize("background", [
    (0.1, 0.2, 0.3, 1.0), (0.0, 0.0, 0.0, 0.0), (0.5, 0.25, 0.75, 0.0),
    (0.2, 0.4, 0.6, 0.5)])
def test_model_blends_each_background(background):
    rgb, alpha, coeffs, sign_ok = _setup(CAMERAS[3])
    got = _check(rgb, alpha, coeffs, sign_ok, background, False, False)
    if background[3] == 1.0:
        np.testing.assert_array_equal(got[..., 3], 1.0)
    if background[3] == 0.0:  # uncovered pixels stay transparent
        assert (got[..., 3] == 0.0).any()


def test_model_carries_depth_values_above_one():
    """iso_fast's depth warp: distances ride channel 0 with coverage as
    alpha over a transparent background."""
    rgb, alpha, coeffs, sign_ok = _setup(CAMERAS[0])
    found = (alpha > 0.5).to(torch.float32)
    dist = torch.where(found > 0, 1.0 + 2.0 * rgb[..., 0], 0.0)
    zeros = torch.zeros_like(dist)
    got = _check(torch.stack([dist, zeros, zeros], dim=-1), found, coeffs,
                 sign_ok, (0.0, 0.0, 0.0, 0.0), False, False)
    assert got[..., 0].max() > 1.0


def test_model_masks_rays_behind_the_camera():
    rgb, alpha, coeffs, sign_ok = _setup(CAMERAS[0])
    # The opposite sign: every ray counts as behind, the frame is the
    # background.
    got = _check(rgb, alpha, coeffs, -sign_ok, BG, False, False)
    np.testing.assert_array_equal(got, np.broadcast_to(np.float32(BG),
                                                       got.shape))
    # A denominator that changes sign mid-screen: the pole at px = 48.
    a_c, b_c, _ = coeffs
    c_c = np.array([1.0, -2.0 / WIDTH, 0.0])
    got = _check(rgb, alpha, (a_c, b_c, c_c), 1.0, BG, False, False)
    np.testing.assert_array_equal(got[:, WIDTH // 2:],
                                  np.broadcast_to(np.float32(BG),
                                                  got[:, WIDTH // 2:].shape))


def test_model_drops_coordinates_off_the_intermediate():
    """The map shifted so that parts of the screen fall left, right,
    above and below the intermediate."""
    rgb, alpha, coeffs, sign_ok = _setup(CAMERAS[0])
    hi, wi = alpha.shape
    a_c, b_c, c_c = (np.array(x, np.float64) for x in coeffs)
    a_c[0] -= 0.5 * wi * c_c[0]
    b_c[0] += 0.6 * hi * c_c[0]
    a_c[1] *= 1.7
    got = _check(rgb, alpha, (a_c, b_c, c_c), sign_ok, BG, False, False)
    bg = np.float32(BG)
    assert (got == bg).all(-1).any() and not (got == bg).all()


@pytest.mark.parametrize("which", ["sv", "u"])
def test_model_drops_infinite_coordinates(which):
    """B2 (A1) large enough that sv (u) overflows to ±inf on most of the
    screen: no tap there, in either version."""
    rgb, alpha, coeffs, sign_ok = _setup(CAMERAS[0])
    a_c, b_c, c_c = (np.array(x, np.float64) for x in coeffs)
    if which == "sv":
        b_c[2] = 3e38
    else:
        a_c[1] = 3e38
    got = _check(rgb, alpha, (a_c, b_c, c_c), sign_ok, BG, False, False)
    assert np.isfinite(got).all()
    off = got[:, 4:] if which == "u" else got[4:]
    np.testing.assert_array_equal(off, np.broadcast_to(np.float32(BG),
                                                       off.shape))


def test_model_takes_no_tap_at_a_nan_coordinate():
    """A NaN coordinate finds its first tap at −2: no tap, the pixel is
    the background. (The plain's NaN tent weights make its frame NaN, as
    0 · NaN in a dense product would; no camera gives a NaN coordinate.)"""
    rgb, alpha, coeffs, sign_ok = _setup(CAMERAS[0])
    a_c, b_c, c_c = (np.array(x, np.float64) for x in coeffs)
    b_c[0] = np.nan
    got = warp_model(rgb, alpha, (a_c, b_c, c_c), sign_ok, BG, False, False,
                     WIDTH, HEIGHT)
    np.testing.assert_array_equal(got, np.broadcast_to(np.float32(BG),
                                                       got.shape))
    want = warp_two_pass_plain(rgb, alpha, (a_c, b_c, c_c), sign_ok, BG,
                               False, False, WIDTH, HEIGHT)
    assert torch.isnan(want).all()


def test_two_taps_hold_every_nonzero_tent_weight():
    """The kernel's premise: the dense bf16 tent over taps 0..T−1 is zero
    outside the two taps ``first_tap`` finds, whatever the coordinate."""
    taps = 40
    rng = np.random.default_rng(5)
    coords = np.concatenate([
        rng.uniform(-3.0, taps + 2.0, 4000), np.arange(-3, taps + 3),
        np.arange(-3, taps + 3) + 0.5, np.arange(-3, taps + 3) - 1e-6,
        [np.inf, -np.inf, 1e30, -1e30, taps - 1 + 1e-5, -1 + 1e-6],
    ]).astype(F)
    dense = _tent(torch.from_numpy(coords)[:, None],
                  torch.arange(taps, dtype=torch.float32)).numpy()
    two = np.zeros_like(dense)
    j0 = first_tap(coords, taps)
    for dj in (0, 1):
        j = j0 + dj
        inside = (j >= 0) & (j <= taps - 1)
        idx = np.nonzero(inside)[0]
        two[idx, j[idx]] = tent(coords[idx], j[idx])
    np.testing.assert_array_equal(two, dense)


def test_variant_coeffs_swap_axes():
    coeffs = (np.array([1.0, 2.0, 3.0]), np.array([4.0, 5.0, 6.0]),
              np.array([7.0, 8.0, 9.0]))
    assert variant_coeffs(coeffs, False, False) == [[1, 2, 3], [4, 5, 6],
                                                    [7, 8, 9]]
    assert variant_coeffs(coeffs, True, False) == [[4, 5, 6], [1, 2, 3],
                                                   [7, 8, 9]]
    assert variant_coeffs(coeffs, True, True) == [[4, 6, 5], [1, 3, 2],
                                                  [7, 9, 8]]

