"""Perspective shear-warp direct volume rendering.

Counterpart of ``correrender_tpu/render/dvr_fast.py``. A frame is:

1. **Classify** the field through the transfer function into the
   compositor's slice layout (K2, :func:`prepare_shearwarp`), or take a
   classified volume (``classified=``, e.g. B3's output masked by a
   render restriction) into that layout.
2. **Shear (composite)**: slices along the principal axis are projected
   through the eye onto the reference plane (the nearest slice plane).
   That projection is a per-slice uniform scale about the eye's in-plane
   point, so every intermediate pixel is an exact eye ray and each
   slice-plane intersection an exact sample of it (K3). The volume is
   zero outside the box: exact box clipping by zero tent weights.
3. **Warp**: one 2D homography from the reference plane to the screen,
   two passes of per-line tent resampling as large matrix products.

Reference semantics: DvrShader.glsl compositing (alpha = 1 −
exp(−τ·Δs·attenuation), premultiplied OVER, background blend,
un-premultiply — DvrShader.glsl:103-137).

A camera whose eye is inside (or past the near face of) the
principal-axis slab cannot be factored; such frames go to the
fixed-step marcher (``render/dvr.py::dvr_render``), as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.ops.cuda.shearwarp_kernel import (
    classify_to_cf,
    prepare_cvol_cf,
    round_bf16,
    shearwarp_composite,
)
from correrender_tpu_torch.ops.precision import f32_matmul
from correrender_tpu_torch.render.camera import (
    default_render_box,
    ray_dirs_affine,
)
from correrender_tpu_torch.render.dvr import blend_background, dvr_render

_EPS = 1e-6
_WARP_CHUNK = 16  # rows (pass A) or columns (pass B) per warp product
_WORLD_TO_ARR = {2: 0, 1: 1, 0: 2}  # volume axes (z, y, x) = world (2, 1, 0)


def _principal_axis(forward: np.ndarray) -> int:
    return int(np.argmax(np.abs(forward)))  # 0=x, 1=y, 2=z (world)


def shearwarp_camera_key(camera) -> tuple:
    """(principal axis, slice order): the key a prepared layout is
    valid for; cheap to evaluate per frame."""
    _, a, _, flip = shearwarp_axes(camera)
    return (a, flip)


def shearwarp_axes(camera):
    """(eye, principal world axis a, in-plane world axes (u, v), flip):
    the slices run along ``a``, near → far after ``flip``."""
    eye = np.asarray(camera.position, np.float32)
    forward = np.asarray(camera.look_at_point, np.float32) - eye
    forward = forward / np.linalg.norm(forward)
    a = _principal_axis(forward)
    return eye, a, [i for i in range(3) if i != a], bool(forward[a] < 0)


def slice_perm(a: int, in_plane) -> tuple:
    """Array axes (slice, v, u) of a ``(Z, Y, X)`` volume for principal
    world axis ``a`` and in-plane world axes ``(u, v)``."""
    return (_WORLD_TO_ARR[a], _WORLD_TO_ARR[in_plane[1]],
            _WORLD_TO_ARR[in_plane[0]])


def shearwarp_geometry(camera, box_min, box_max, a, in_plane, flip,
                       s, nv, nu, image_size, intermediate_scale,
                       device=None):
    """Shear-warp slice and grid geometry.

    Returns a dict with: slice_coords (near→far), coords_v/coords_u,
    g, z_ref, e_u/e_v, grid_u/grid_v (host f32), hi_res/wi_res,
    len_factor (a ``(hi, wi)`` tensor built on ``device``) and
    slab_thickness.
    """
    eye = np.asarray(camera.position, np.float32)

    # World coordinates of voxel centres along each axis. Array index
    # ascends with world coordinate for (z, y, x) ordering.
    def centers(world_axis, count):
        lo, hi_ = box_min[world_axis], box_max[world_axis]
        return lo + (np.arange(count) + 0.5) / count * (hi_ - lo)

    slice_coords = centers(a, s)
    coords_v = centers(in_plane[1], nv)
    coords_u = centers(in_plane[0], nu)
    if flip:
        slice_coords = slice_coords[::-1]
    e_a = eye[a]
    z_ref = slice_coords[0]
    denom = z_ref - e_a
    if abs(denom) < 1e-6:
        denom = np.sign(denom or 1.0) * 1e-6
    g = (slice_coords - e_a) / denom  # (S,) ≥ 1 when the eye is outside

    # Intermediate grid: union of slice footprints projected to the
    # reference plane through the eye (q_ref = e + (q − e)/g_k).
    e_u, e_v = eye[in_plane[0]], eye[in_plane[1]]
    lo_u = hi_u = lo_v = hi_v = None
    for gk in (g.min(), g.max(), 1.0):
        if gk <= 0:
            continue
        cu = e_u + (np.array([coords_u[0], coords_u[-1]]) - e_u) / gk
        cv = e_v + (np.array([coords_v[0], coords_v[-1]]) - e_v) / gk
        lo_u = cu.min() if lo_u is None else min(lo_u, cu.min())
        hi_u = cu.max() if hi_u is None else max(hi_u, cu.max())
        lo_v = cv.min() if lo_v is None else min(lo_v, cv.min())
        hi_v = cv.max() if hi_v is None else max(hi_v, cv.max())

    width, height = image_size
    hi_res = max(int(height * intermediate_scale), 2 * nv)
    wi_res = max(int(width * intermediate_scale), 2 * nu)
    # One-texel safety margin so box-silhouette content never touches
    # the grid boundary (the warp's tent weights fall off over one texel).
    margin_u = 2.0 * (hi_u - lo_u) / wi_res
    margin_v = 2.0 * (hi_v - lo_v) / hi_res
    grid_u = np.linspace(
        lo_u - margin_u, hi_u + margin_u, wi_res
    ).astype(np.float32)
    grid_v = np.linspace(
        lo_v - margin_v, hi_v + margin_v, hi_res
    ).astype(np.float32)

    # Per-intermediate-pixel path-length factor |d| / |d_a| of the ray
    # eye → reference-plane point, built on the device from the 1D grids.
    d_u = torch.as_tensor(grid_u, device=device)[None, :] - float(e_u)
    d_v = torch.as_tensor(grid_v, device=device)[:, None] - float(e_v)
    d_a = float(z_ref - e_a)
    len_factor = torch.sqrt(d_u**2 + d_v**2 + d_a**2) / max(abs(d_a), 1e-9)
    slab_thickness = float(
        abs(slice_coords[1] - slice_coords[0]) if s > 1 else
        (box_max[a] - box_min[a])
    )
    return dict(
        slice_coords=slice_coords, coords_v=coords_v, coords_u=coords_u,
        g=g, z_ref=z_ref, e_u=e_u, e_v=e_v, grid_u=grid_u,
        grid_v=grid_v, hi_res=hi_res, wi_res=wi_res,
        len_factor=len_factor, slab_thickness=slab_thickness,
    )


def composite_inputs(geo: dict, device=None) -> dict:
    """The compositor's geometry arguments from :func:`shearwarp_geometry`,
    as keyword arguments of ``shearwarp_composite``."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return dict(
        g=f32(geo["g"]), coords_y=f32(geo["coords_v"]),
        coords_x=f32(geo["coords_u"]), grid_v=f32(geo["grid_v"]),
        grid_u=f32(geo["grid_u"]), eye_uv=(geo["e_u"], geo["e_v"]),
        len_factor=geo["len_factor"], slab_thickness=geo["slab_thickness"],
    )


def shearwarp_viable(camera, box) -> bool:
    """Whether the shear-warp factorization applies for this camera.

    False when the eye is inside (or past the near face of) the
    principal-axis slab: behind-eye slices flip the projection sign.
    """
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    eye, a, _, flip = shearwarp_axes(camera)
    if not flip:
        return bool(eye[a] < box_min[a])
    return bool(eye[a] > box_max[a])


def prepare_shearwarp(volume: torch.Tensor, transfer_function,
                      camera, classified: torch.Tensor | None = None) -> dict:
    """Build the compositor's resident slice layout for a camera.

    Classifies the ``(Z, Y, X)`` field into the ``(S, Yv, Xv, 4)`` bf16
    layout with K2, which reads the field through the orientation's
    strides. With ``classified`` (a ``(Z, Y, X, 4)`` premultiplied RGBA
    volume, e.g. :func:`render.classify.classify_volume` times a
    restriction mask) that volume is oriented and cast into the layout
    instead (:func:`prepare_cvol_cf`), and the transfer function is not
    read. The JAX package also keeps a transposed scalar copy to
    reuse across transfer-function changes (``prior=``); here the
    oriented field is a strided view that costs nothing to rebuild, so
    there is no prior.

    Pass the result to :func:`dvr_shearwarp` via ``prepared=``; it is
    keyed by (principal axis, slice order) and rebuilt automatically
    when the camera crosses an axis boundary.
    """
    _, a, in_plane, flip = shearwarp_axes(camera)
    perm = slice_perm(a, in_plane)
    if classified is None:
        cf = classify_to_cf(volume, perm, flip, transfer_function.lut,
                            transfer_function.domain)
    else:
        cvol = classified.permute(*perm, 3)
        cf = prepare_cvol_cf(cvol.flip(0) if flip else cvol)
    return {"key": (a, flip), "perm": perm, "s": cf.shape[0],
            "vu": (cf.shape[1], cf.shape[2]), "cf": cf}


def dvr_shearwarp(
    volume: torch.Tensor,
    camera,
    transfer_function,
    image_size=(1920, 1080),
    box=None,
    attenuation: float = 100.0,
    background=(0.0, 0.0, 0.0, 1.0),
    intermediate_scale: float = 1.0,
    classified: torch.Tensor | None = None,
    prepared: dict | None = None,
    depth_limit=None,
    on_stage=None,
) -> torch.Tensor:
    """Fast DVR (see module docstring).

    Args:
      volume: ``(Z, Y, X)`` float32 scalar field.
      intermediate_scale: intermediate-grid resolution multiplier
        relative to the larger of (image size, 2× volume face).
      classified: optionally a ``(Z, Y, X, 4)`` premultiplied RGBA volume
        to composite instead of classifying ``volume`` (see
        :func:`prepare_shearwarp`); unused when ``prepared`` matches.
      prepared: a :func:`prepare_shearwarp` result, reused while its
        camera key (principal axis, slice order) still matches.
      depth_limit: optional ``(H, W)`` world eye distances (the shared
        per-view depth buffer). Pulled into the intermediate grid
        through the inverse screen homography and converted to
        fractional stop-slice indices (K3's ``kstop``).
      on_stage: optional ``on_stage(name, result)`` called as each stage
        has been enqueued: ``"classify"`` (the prepared layout),
        ``"composite"`` (``(rgb, alpha, geometry)``) and ``"warp"`` (the
        frame). For stage timing; the frame does not depend on it.

    Returns:
      ``(H, W, 4)`` straight-alpha RGBA on the volume's device. A camera
      that :func:`shearwarp_viable` rejects is rendered by
      :func:`render.dvr.dvr_render` from ``volume`` and the transfer
      function (``classified`` cannot be carried there, as in the JAX
      package), without stage callbacks.
    """
    zs, ys, xs = volume.shape
    if box is None:
        box = default_render_box((zs, ys, xs))
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    if not shearwarp_viable(camera, (box_min, box_max)):
        return dvr_render(volume, camera, transfer_function,
                          image_size=image_size, box=box,
                          attenuation=attenuation, background=background,
                          depth_limit=depth_limit)

    eye, a, in_plane, flip = shearwarp_axes(camera)
    if prepared is None or prepared["key"] != (a, flip):
        prepared = prepare_shearwarp(volume, transfer_function, camera,
                                     classified=classified)
    stage = on_stage or (lambda name, result: None)
    stage("classify", prepared)
    n_slices = prepared["s"]
    nv, nu = prepared["vu"]

    dev = volume.device
    geo = shearwarp_geometry(
        camera, box_min, box_max, a, in_plane, flip, n_slices, nv, nu,
        image_size, intermediate_scale, device=dev,
    )
    width, height = image_size
    kstop = None
    if depth_limit is not None:
        kstop = _depth_to_kstop(depth_limit, camera, width, height, in_plane,
                                a, eye, geo)
    inter_rgb, inter_a = shearwarp_composite(
        prepared["cf"], **composite_inputs(geo, dev), attenuation=attenuation,
        kstop=kstop)
    stage("composite", (inter_rgb, inter_a, geo))

    image = warp_to_screen(
        inter_rgb, inter_a, camera, width, height, in_plane, a, eye,
        geo["z_ref"], geo["grid_u"], geo["grid_v"], background,
    )
    stage("warp", image)
    return image


def _depth_to_kstop(depth_limit, camera, width, height, in_plane, a, eye,
                    geo) -> torch.Tensor:
    """Screen-space depth buffer → fractional stop-slice indices
    ``(hi, wi)`` on the intermediate grid.

    The 3×3 inverse of the intermediate → screen homography maps every
    intermediate pixel to its screen position, where the depth buffer is
    sampled bilinearly (+inf, and positions off the screen, mean no
    clip). Depth along a ray is linear in the slice coordinate,
    ``dist(k) = (|s₀ − e_a| + k·|Δs|)·len_factor``, so the sampled
    distance converts to a fractional slice index in closed form.
    """
    z_ref, grid_u, grid_v = geo["z_ref"], geo["grid_u"], geo["grid_v"]
    len_factor, slice_coords = geo["len_factor"], geo["slice_coords"]
    n_slices = len(slice_coords)
    m = np.array(_homography_coeffs(camera, width, height, in_plane, a, eye,
                                    z_ref, grid_u, grid_v), np.float64)
    try:
        minv = np.linalg.inv(m)
    except np.linalg.LinAlgError as exc:
        raise ValueError(
            "depth_limit: degenerate screen homography for this camera"
        ) from exc
    dev = len_factor.device
    su = torch.arange(len(grid_u), dtype=torch.float32, device=dev)[None, :]
    sv = torch.arange(len(grid_v), dtype=torch.float32, device=dev)[:, None]
    mi = [[float(v) for v in row] for row in minv.astype(np.float32)]
    q0 = mi[0][0] * su + mi[0][1] * sv + mi[0][2]
    q1 = mi[1][0] * su + mi[1][1] * sv + mi[1][2]
    q2 = mi[2][0] * su + mi[2][1] * sv + mi[2][2]
    q0 = torch.where(q0.abs() < 1e-12, 1e-12, q0)
    px = q1 / q0
    py = q2 / q0

    d = torch.as_tensor(depth_limit, dtype=torch.float32, device=dev)
    d = torch.where(torch.isfinite(d), d, 1e9)
    # Clamped before the integer cast, which is undefined for huge or
    # NaN values; positions off the screen are masked below anyway.
    x0i = torch.clamp(torch.floor(torch.clamp(px, -1.0, float(width))),
                      0, width - 2).to(torch.long)
    y0i = torch.clamp(torch.floor(torch.clamp(py, -1.0, float(height))),
                      0, height - 2).to(torch.long)
    fx = torch.clamp(px - x0i, 0.0, 1.0)
    fy = torch.clamp(py - y0i, 0.0, 1.0)
    dint = (
        d[y0i, x0i] * (1 - fy) * (1 - fx)
        + d[y0i, x0i + 1] * (1 - fy) * fx
        + d[y0i + 1, x0i] * fy * (1 - fx)
        + d[y0i + 1, x0i + 1] * fy * fx
    )
    outside = (px < 0) | (px > width - 1) | (py < 0) | (py > height - 1)
    dint = torch.where(outside, 1e9, dint)
    step_abs = (abs(float(slice_coords[1] - slice_coords[0]))
                if n_slices > 1 else 1.0)
    base = abs(float(slice_coords[0] - eye[a]))
    kstop = (dint / torch.clamp_min(len_factor, 1e-9) - base) / step_abs
    return torch.clamp(kstop, 0.0, float(n_slices))


def warp_to_screen(
    inter_rgb, inter_a, camera, width, height, in_plane, a, eye,
    z_ref, grid_u, grid_v, background,
):
    """Homography-warp an intermediate image to the screen.

    Catmull–Smith pass-order selection: four factorizations exist
    (intermediate transpose × output transpose); each has a pole where
    its per-line inversion denominator vanishes. A variant is invalid
    when its inverted coordinate does not influence the inverted map at
    all; otherwise it is scored by the pole's distance outside the used
    range. The gather warp runs only if all four fail.
    """
    hi_res, wi_res = inter_a.shape
    e_a = eye[a]
    a_coef, b_coef, c_coef = _homography_coeffs(
        camera, width, height, in_plane, a, eye, z_ref, grid_u, grid_v
    )

    def score(num, den, extent):
        if abs(den) < 1e-12:
            return np.inf if abs(num) > 1e-12 else -np.inf
        pole = num / den
        if pole < 0:
            return -pole / extent
        if pole > extent - 1:
            return (pole - (extent - 1)) / extent
        return -np.inf  # pole inside the image

    # (score, transpose_intermediate, transpose_output). With the
    # intermediate transposed, pass A runs over its columns (wi).
    variants = [
        (score(b_coef[2], c_coef[2], hi_res), False, False),
        (score(b_coef[1], c_coef[1], hi_res), False, True),
        (score(a_coef[2], c_coef[2], wi_res), True, False),
        (score(a_coef[1], c_coef[1], wi_res), True, True),
    ]
    best, t_int, t_out = max(variants, key=lambda v: v[0])
    if best == -np.inf:
        return _gather_warp(inter_rgb, inter_a, camera, width, height,
                            in_plane, a, z_ref, grid_u, grid_v, background)

    def idx_swap(c):
        return np.asarray([c[0], c[2], c[1]])

    ca, cb, cc = a_coef, b_coef, c_coef
    rgb_in, a_in = inter_rgb, inter_a
    w_o, h_o = width, height
    if t_int:
        ca, cb = cb, ca
        rgb_in = rgb_in.transpose(0, 1)
        a_in = a_in.transpose(0, 1)
    if t_out:
        ca, cb, cc = idx_swap(ca), idx_swap(cb), idx_swap(cc)
        w_o, h_o = height, width
    out = _warp_matmul(
        rgb_in, a_in, ca, cb, cc, float(np.sign(z_ref - e_a) or 1.0),
        background, w_o, h_o,
    )
    return out.transpose(0, 1) if t_out else out


def _gather_warp(inter_rgb, inter_a, camera, width, height, in_plane, a,
                 z_ref, grid_u, grid_v, background):
    origin, directions = camera.rays(width, height, device=inter_a.device)
    return _warp(inter_rgb, inter_a, grid_u, grid_v, origin, directions,
                 in_plane[0], in_plane[1], float(z_ref), a, background)


def _warp(inter_rgb, inter_a, grid_u, grid_v, origin, directions,
          u_axis: int, v_axis: int, z_ref: float, a_axis: int, background):
    """Gather warp: intersect every screen ray with the reference plane
    and sample the intermediate image bilinearly there."""
    d_a = directions[..., a_axis]
    t = (z_ref - origin[a_axis]) / torch.where(d_a.abs() < _EPS, _EPS, d_a)
    p = origin + directions * t[..., None]
    pu, pv = p[..., u_axis], p[..., v_axis]
    su = (pu - float(grid_u[0])) / float(grid_u[-1] - grid_u[0]) * (
        len(grid_u) - 1)
    sv = (pv - float(grid_v[0])) / float(grid_v[-1] - grid_v[0]) * (
        len(grid_v) - 1)
    valid = t > 0

    hi, wi = inter_a.shape
    i0 = torch.clamp(torch.floor(sv).to(torch.long), 0, hi - 2)
    j0 = torch.clamp(torch.floor(su).to(torch.long), 0, wi - 2)
    fv = sv - i0
    fu = su - j0
    inside = (sv >= 0) & (sv <= hi - 1) & (su >= 0) & (su <= wi - 1)

    def bilerp(img):
        fv_ = fv[..., None] if img.dim() == 3 else fv
        fu_ = fu[..., None] if img.dim() == 3 else fu
        return (
            img[i0, j0] * (1 - fv_) * (1 - fu_)
            + img[i0, j0 + 1] * (1 - fv_) * fu_
            + img[i0 + 1, j0] * fv_ * (1 - fu_)
            + img[i0 + 1, j0 + 1] * fv_ * fu_
        )

    mask = (valid & inside).to(torch.float32)
    rgb = bilerp(inter_rgb) * mask[..., None]
    # Resampling can overshoot alpha past 1 by ~2e-3 (bf16 tent
    # weights); a > 1 would make the (1 − a) background term negative.
    alpha = torch.clamp(bilerp(inter_a) * mask, 0.0, 1.0)
    return blend_background(rgb, alpha, background)


# ---------------------------------------------------------------------------
# Gather-free homography warp (two-pass per-line matmul resampling)
# ---------------------------------------------------------------------------
#
# The reference-plane → screen map is projective with a shared affine
# denominator:
#
#     su(px,py) = (A0 + A1·px + A2·py) / (C0 + C1·px + C2·py)
#     sv(px,py) = (B0 + B1·px + B2·py) / (C0 + C1·px + C2·py)
#
# It factors into two passes of per-line 1D resampling (Catmull–Smith):
#
#     pass A:  T(a, y)   = I(u(a, y), y)      with sv(a, py*) = y
#     pass B:  S(px, py) = T(px, sv(px, py))
#
# Each pass builds dense tent (bilinear) weights and contracts them with
# the image in one batched matrix product, in row or column chunks: the
# full (Hi, Wo, Wi) weight tensor at 1080p is about 2.2 G elements.


def _homography_coeffs(camera, width, height, in_plane, a_axis_idx,
                       eye, z_ref, grid_u, grid_v):
    """(A, B, C) affine coefficient triplets over pixel coords."""
    e0, ex, ey = ray_dirs_affine(camera, width, height)
    o = np.asarray(eye, np.float64)
    k = float(z_ref) - o[a_axis_idx]
    dug = (grid_u[-1] - grid_u[0]) / (len(grid_u) - 1)
    dvg = (grid_v[-1] - grid_v[0]) / (len(grid_v) - 1)

    def coeff(axis, g0, scale):
        # s = ((o_axis − g0)·d_a + k·d_axis) / (scale · d_a)
        num = np.array(
            [
                (o[axis] - g0) * e0[a_axis_idx] + k * e0[axis],
                (o[axis] - g0) * ex[a_axis_idx] + k * ex[axis],
                (o[axis] - g0) * ey[a_axis_idx] + k * ey[axis],
            ]
        )
        return num / scale

    a_coef = coeff(in_plane[0], grid_u[0], dug)
    b_coef = coeff(in_plane[1], grid_v[0], dvg)
    c_coef = np.array([e0[a_axis_idx], ex[a_axis_idx], ey[a_axis_idx]])
    return a_coef, b_coef, c_coef


def _safe(den):
    return torch.where(den.abs() < 1e-12, 1e-12, den)


def _tent(coord: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """bf16-rounded tent weights ``max(1 − |coord − tap|, 0)``."""
    return round_bf16(torch.clamp_min(1.0 - (coord - taps).abs(), 0.0))


# The reference rounds tent weights and image to bf16 and sums the
# products in f32. TF32 holds bf16 values exactly, so it would not change
# the products, only the kernel and its summation order: pinned off.
@f32_matmul()
def _warp_matmul(
    inter_rgb,  # (Hi, Wi, 3) premultiplied
    inter_a,  # (Hi, Wi)
    a_coef, b_coef, c_coef,  # (3,) host coefficients each
    sign_ok: float,  # +1/−1: required sign of the denominator
    background,
    w_out: int,
    h_out: int,
):
    dev = inter_a.device
    hi, wi = inter_a.shape
    img = round_bf16(torch.cat([inter_rgb, inter_a[..., None]], dim=-1))

    def f32(c):  # the reference holds the coefficients as f32 scalars
        return [float(np.float32(v)) for v in c]

    a0, a1, a2 = f32(a_coef)
    b0, b1, b2 = f32(b_coef)
    c0, c1, c2 = f32(c_coef)

    # --- pass A: T[y, a] = I[y, u(a, y)] --------------------------------
    a_idx = torch.arange(w_out, dtype=torch.float32, device=dev)
    y_idx = torch.arange(hi, dtype=torch.float32, device=dev)
    # py*(a, y): sv(a, py) = y  →  py = (y(C0+C1 a) − B0 − B1 a)/(B2 − y C2)
    num = y_idx[:, None] * (c0 + c1 * a_idx[None, :]) - (
        b0 + b1 * a_idx[None, :]
    )
    den = b2 - y_idx[:, None] * c2
    py_star = num / _safe(den)  # (Hi, Wo)
    u_den = c0 + c1 * a_idx[None, :] + c2 * py_star
    u = (a0 + a1 * a_idx[None, :] + a2 * py_star) / _safe(u_den)

    cols = torch.arange(wi, dtype=torch.float32, device=dev)
    t_img = torch.empty((hi, w_out, 4), dtype=torch.float32, device=dev)
    for r0 in range(0, hi, _WARP_CHUNK):
        r1 = r0 + _WARP_CHUNK
        w = _tent(u[r0:r1, :, None], cols)  # (c, Wo, Wi)
        t_img[r0:r1] = torch.bmm(w, img[r0:r1])
    t_img = round_bf16(t_img)

    # --- pass B: S[py, px] = T[sv(px, py), px] ---------------------------
    px = torch.arange(w_out, dtype=torch.float32, device=dev)
    py = torch.arange(h_out, dtype=torch.float32, device=dev)
    den_full = c0 + c1 * px[None, :] + c2 * py[:, None]  # (Ho, Wo)
    sv = (b0 + b1 * px[None, :] + b2 * py[:, None]) / _safe(den_full)

    rows = torch.arange(hi, dtype=torch.float32, device=dev)
    s_img = torch.empty((w_out, h_out, 4), dtype=torch.float32, device=dev)
    for x0 in range(0, w_out, _WARP_CHUNK):
        x1 = x0 + _WARP_CHUNK
        w = _tent(sv[:, x0:x1].T[..., None], rows)  # (c, Ho, Hi)
        s_img[x0:x1] = torch.bmm(w, t_img[:, x0:x1].transpose(0, 1))
    return _warp_finish(s_img.transpose(0, 1), den_full, sign_ok,
                        background)


def _warp_finish(s_img, den_full, sign_ok, background):
    # Validity: forward rays only (the tent already zeros out-of-range
    # samples, but behind-the-camera rays need the sign mask).
    valid = (den_full * sign_ok > 0).to(torch.float32)
    rgb = s_img[..., :3] * valid[..., None]
    alpha = torch.clamp(s_img[..., 3] * valid, 0.0, 1.0)  # see _warp
    return blend_background(rgb, alpha, background)
