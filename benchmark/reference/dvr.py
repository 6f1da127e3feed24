"""A plain shear-warp DVR frame: the reference of the Scene's ``dvr`` frame.

The same factorization as the renderer under test, written out plainly:

1. classify: each voxel's scalar through the transfer function's LUT
   (linear interpolation between two bins, clamp to edge, NaN to 0),
   premultiplied, into slices along the view's principal axis, ordered
   near to far, rounded to the layout's precision (bfloat16);
2. composite: each slice resampled onto the intermediate grid through
   the eye (two separable tent passes, weights and the value between
   the passes rounded to bfloat16, float32 sums), then front-to-back
   OVER with the opacity correction ``1 − exp(−τ·Δs·len·attenuation)``;
3. warp: the intermediate image to the screen by the reference-plane
   homography in two passes of per-line linear interpolation
   (Catmull–Smith), weights and the pass-A image rounded to bfloat16,
   then blended over the background and un-premultiplied.

The warp is evaluated by gathering each output sample's two taps; the
renderer under test contracts dense tent rows with matrix products. Both
are the same sums: every other tap weighs exactly zero.

``layout_dtype`` replaces the bfloat16 of step 1 (a control computes the
frame with an 8-bit layout).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-6
_CHUNK = 16  # slices per step of the composite
_WORLD_TO_ARR = {2: 0, 1: 1, 0: 2}  # volume axes (z, y, x) = world (2, 1, 0)

COLORMAPS = {
    "coolwarm": [
        (0.0, (0.231, 0.299, 0.754)),
        (0.5, (0.865, 0.865, 0.865)),
        (1.0, (0.706, 0.016, 0.150)),
    ],
}


def default_opacity_points(lo: float, hi: float):
    """A sign-spanning domain gets a zero-opacity notch at its centre, a
    one-signed domain a plain ramp."""
    return (((0.0, 0.7), (0.5, 0.0), (1.0, 0.7))
            if lo < 0 < hi else ((0.0, 0.0), (1.0, 0.8)))


def lut_from_points(colormap: str, opacity_points,
                    resolution: int = 256) -> np.ndarray:
    """``(resolution, 4)`` float32 straight-alpha LUT, each channel
    interpolated linearly between its control points."""
    t = np.linspace(0.0, 1.0, resolution, dtype=np.float32)

    def sample(points):
        xs = np.array([p[0] for p in points], np.float32)
        vals = np.array([p[1] for p in points], np.float32)
        return np.stack([np.interp(t, xs, vals[:, c])
                         for c in range(vals.shape[1])], axis=-1)

    colors = [(float(x), tuple(float(v) for v in c))
              for x, c in COLORMAPS[colormap]]
    alpha = [(float(x), (float(a),)) for x, a in opacity_points]
    return np.concatenate([sample(colors), sample(alpha)],
                          axis=-1).astype(np.float32)


def round_to(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).to(torch.float32)


# -- camera -----------------------------------------------------------------

def _look_at(eye, center, up) -> np.ndarray:
    eye, center, up = (np.asarray(v, np.float32) for v in (eye, center, up))
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def _perspective(fovy, aspect, z_near, z_far) -> np.ndarray:
    t = 1.0 / math.tan(fovy * 0.5)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = (z_far + z_near) / (z_near - z_far)
    m[2, 3] = 2.0 * z_far * z_near / (z_near - z_far)
    m[3, 2] = -1.0
    return m


def _ray_dirs_affine(cam: dict, width: int, height: int):
    """float64 ``(e0, ex, ey)``: the ray through pixel centre (px, py),
    row 0 at the top, points along ``e0 + ex·px + ey·py``."""
    inv_view = np.linalg.inv(_look_at(cam["position"], cam["look_at"],
                                      cam["up"])).astype(np.float32)
    inv_proj = np.linalg.inv(_perspective(
        cam["fovy"], width / height, cam["z_near"],
        cam["z_far"])).astype(np.float32)

    def dir3(px, py):
        x = 2.0 * (px + 0.5) / width - 1.0
        y = 1.0 - 2.0 * (py + 0.5) / height
        target = inv_proj @ np.array([x, y, 1.0, 1.0], np.float64)
        return inv_view[:3, :3].astype(np.float64) @ target[:3]

    d00 = dir3(0, 0)
    return d00, dir3(1, 0) - d00, dir3(0, 1) - d00


def render_box(shape_zyx):
    """The normalized render box: ±0.25 · extent / max(extent), extent
    ``(xs − 1, ys − 1, zs − 1)`` at unit spacing."""
    zs, ys, xs = shape_zyx
    wmax = np.array([xs - 1, ys - 1, zs - 1], np.float32)
    normalized = np.maximum(wmax, 1e-30) / np.maximum(wmax, 1e-30).max()
    return ((-0.25 * normalized).astype(np.float32),
            (0.25 * normalized).astype(np.float32))


def view_axes(cam: dict):
    """(eye, principal world axis, in-plane axes (u, v), slices reversed)."""
    eye = np.asarray(cam["position"], np.float32)
    forward = np.asarray(cam["look_at"], np.float32) - eye
    forward = forward / np.linalg.norm(forward)
    a = int(np.argmax(np.abs(forward)))
    return eye, a, [i for i in range(3) if i != a], bool(forward[a] < 0)


def intermediate_shape(shape_zyx, cam: dict, image_size,
                       scale: float = 1.0):
    """(slices, hi, wi, yv, xv) of the frame's composite."""
    _, a, in_plane, _ = view_axes(cam)
    dims = {0: shape_zyx[2], 1: shape_zyx[1], 2: shape_zyx[0]}
    nv, nu = dims[in_plane[1]], dims[in_plane[0]]
    width, height = image_size
    return (dims[a], max(int(height * scale), 2 * nv),
            max(int(width * scale), 2 * nu), nv, nu)


# -- the frame --------------------------------------------------------------

def classify(field: torch.Tensor, lut: torch.Tensor, domain) -> torch.Tensor:
    """``(..., 4)`` float32 premultiplied RGBA of the scalars."""
    res = lut.shape[0]
    lo, hi = (np.float32(d) for d in domain)
    span = float(hi - lo)
    lo = float(lo)
    if span > 0:
        u = torch.clamp((field - lo) / span, 0.0, 1.0) * (res - 1)
    else:
        u = torch.zeros_like(field)
    u = torch.where(torch.isnan(field), -2.0, u)
    i0 = torch.clamp(torch.floor(u), 0, res - 2)
    w0 = torch.clamp_min(1.0 - (u - i0).abs(), 0.0)[..., None]
    w1 = torch.clamp_min(1.0 - (u - (i0 + 1.0)).abs(), 0.0)[..., None]
    lutp = torch.cat([lut[:, :3] * lut[:, 3:4], lut[:, 3:4]], dim=-1)
    i0 = i0.to(torch.long)
    return lutp[i0] * w0 + lutp[i0 + 1] * w1


def _geometry(cam, box_min, box_max, a, in_plane, flip, s, nv, nu,
              image_size, scale, device):
    eye = np.asarray(cam["position"], np.float32)

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
    g = (slice_coords - e_a) / denom
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
    hi_res = max(int(height * scale), 2 * nv)
    wi_res = max(int(width * scale), 2 * nu)
    margin_u = 2.0 * (hi_u - lo_u) / wi_res
    margin_v = 2.0 * (hi_v - lo_v) / hi_res
    grid_u = np.linspace(lo_u - margin_u, hi_u + margin_u,
                         wi_res).astype(np.float32)
    grid_v = np.linspace(lo_v - margin_v, hi_v + margin_v,
                         hi_res).astype(np.float32)
    d_u = torch.as_tensor(grid_u, device=device)[None, :] - float(e_u)
    d_v = torch.as_tensor(grid_v, device=device)[:, None] - float(e_v)
    d_a = float(z_ref - e_a)
    len_factor = torch.sqrt(d_u**2 + d_v**2 + d_a**2) / max(abs(d_a), 1e-9)
    slab = float(abs(slice_coords[1] - slice_coords[0]) if s > 1
                 else box_max[a] - box_min[a])

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return dict(g=f32(g), coords_v=f32(coords_v), coords_u=f32(coords_u),
                grid_v=f32(grid_v), grid_u=f32(grid_u), e_u=float(e_u),
                e_v=float(e_v), z_ref=z_ref, grid_u_np=grid_u,
                grid_v_np=grid_v, len_factor=len_factor, slab=slab)


def _composite(cf, geo, attenuation):
    """Front-to-back composite of ``(S, Yv, Xv, 4)`` premultiplied
    slices onto the intermediate grid: ``(rgb, alpha)``."""
    s, yv, xv, _ = cf.shape
    g, coords_y, coords_x = geo["g"], geo["coords_v"], geo["coords_u"]
    grid_v, grid_u = geo["grid_v"], geo["grid_u"]
    e_u, e_v = geo["e_u"], geo["e_v"]
    len_factor = geo["len_factor"]
    hi, wi = len_factor.shape
    dy = coords_y[1] - coords_y[0] if yv > 1 else 1.0
    dx = coords_x[1] - coords_x[0] if xv > 1 else 1.0
    acc_rgb = torch.zeros((hi, wi, 3), dtype=torch.float32, device=cf.device)
    acc_a = torch.zeros((hi, wi), dtype=torch.float32, device=cf.device)
    for k0 in range(0, s, _CHUNK):
        gk = g[k0:k0 + _CHUNK]
        qv = e_v + (grid_v[None, :] - e_v) * gk[:, None]
        qu = e_u + (grid_u[None, :] - e_u) * gk[:, None]
        wv = round_to(torch.clamp_min(
            1.0 - (qv[..., None] - coords_y).abs() / dy, 0.0), torch.bfloat16)
        wu = round_to(torch.clamp_min(
            1.0 - (qu[..., None] - coords_x).abs() / dx, 0.0), torch.bfloat16)
        slab = round_to(torch.einsum("kiy,kyxc->kixc", wv, cf[k0:k0 + _CHUNK]),
                        torch.bfloat16)
        slab = torch.einsum("kixc,kjx->kijc", slab, wu)
        tau = slab[..., 3]
        thickness = geo["slab"] * len_factor[None]
        valid = (gk > _EPS).to(torch.float32)[:, None, None]
        alpha = (1.0 - torch.exp(-tau * thickness * attenuation)) * valid
        rgb = alpha[..., None] * (
            slab[..., :3] / torch.clamp_min(tau, _EPS)[..., None])
        trans = torch.cumprod(1.0 - alpha, dim=0)
        before = torch.cat([torch.ones_like(trans[:1]), trans[:-1]])
        acc_rgb = acc_rgb + (1.0 - acc_a)[..., None] * (
            before[..., None] * rgb).sum(0)
        acc_a = acc_a + (1.0 - acc_a) * (1.0 - trans[-1])
    return acc_rgb, acc_a


def _homography(cam, width, height, in_plane, a, eye, z_ref, grid_u, grid_v):
    e0, ex, ey = _ray_dirs_affine(cam, width, height)
    o = np.asarray(eye, np.float64)
    k = float(z_ref) - o[a]
    dug = (grid_u[-1] - grid_u[0]) / (len(grid_u) - 1)
    dvg = (grid_v[-1] - grid_v[0]) / (len(grid_v) - 1)

    def coeff(axis, g0, scale):
        return np.array([
            (o[axis] - g0) * e0[a] + k * e0[axis],
            (o[axis] - g0) * ex[a] + k * ex[axis],
            (o[axis] - g0) * ey[a] + k * ey[axis],
        ]) / scale

    return (coeff(in_plane[0], grid_u[0], dug),
            coeff(in_plane[1], grid_v[0], dvg),
            np.array([e0[a], ex[a], ey[a]]))


def _safe(den):
    return torch.where(den.abs() < 1e-12, 1e-12, den)


def _interp(src: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = Σ_t w(coord[i, j] − t)·src[i, t]`` for the tent
    ``w(d) = max(1 − |d|, 0)`` rounded to bfloat16, over the taps t in
    ``[0, src.shape[1])``: its two taps either side of the coordinate.
    ``src`` is ``(L, T, C)``, ``coord`` ``(L, M)``; returns ``(L, M, C)``."""
    taps = src.shape[1]
    t0 = torch.floor(torch.nan_to_num(coord, nan=-2.0)).clamp(-2, taps)
    out = 0.0
    for t in (t0, t0 + 1.0):
        w = round_to(torch.clamp_min(1.0 - (coord - t).abs(), 0.0),
                     torch.bfloat16)
        inside = (t >= 0) & (t <= taps - 1)
        idx = torch.where(inside, t, 0.0).to(torch.long)
        val = torch.gather(src, 1, idx[..., None].expand(-1, -1,
                                                         src.shape[2]))
        out = out + torch.where(inside, w, 0.0)[..., None] * val
    return out


def _warp(inter_rgb, inter_a, cam, width, height, in_plane, a, eye, z_ref,
          grid_u, grid_v):
    hi_res, wi_res = inter_a.shape
    a_coef, b_coef, c_coef = _homography(cam, width, height, in_plane, a,
                                         eye, z_ref, grid_u, grid_v)

    def score(num, den, extent):
        if abs(den) < 1e-12:
            return np.inf if abs(num) > 1e-12 else -np.inf
        pole = num / den
        if pole < 0:
            return -pole / extent
        if pole > extent - 1:
            return (pole - (extent - 1)) / extent
        return -np.inf

    variants = [
        (score(b_coef[2], c_coef[2], hi_res), False, False),
        (score(b_coef[1], c_coef[1], hi_res), False, True),
        (score(a_coef[2], c_coef[2], wi_res), True, False),
        (score(a_coef[1], c_coef[1], wi_res), True, True),
    ]
    best, t_int, t_out = max(variants, key=lambda v: v[0])
    if best == -np.inf:
        raise NotImplementedError("no two-pass factorization for this view")
    ca, cb, cc = a_coef, b_coef, c_coef
    img = round_to(torch.cat([inter_rgb, inter_a[..., None]], dim=-1),
                   torch.bfloat16)
    w_o, h_o = width, height
    if t_int:
        ca, cb = cb, ca
        img = img.transpose(0, 1)
    if t_out:
        ca, cb, cc = (np.asarray([c[0], c[2], c[1]]) for c in (ca, cb, cc))
        w_o, h_o = height, width
    a0, a1, a2 = (float(np.float32(v)) for v in ca)
    b0, b1, b2 = (float(np.float32(v)) for v in cb)
    c0, c1, c2 = (float(np.float32(v)) for v in cc)
    dev = inter_a.device
    hi = img.shape[0]
    # Pass A: T[y, a] = I[y, u(a, y)] along each intermediate row.
    a_idx = torch.arange(w_o, dtype=torch.float32, device=dev)
    y_idx = torch.arange(hi, dtype=torch.float32, device=dev)
    num = y_idx[:, None] * (c0 + c1 * a_idx[None, :]) - (
        b0 + b1 * a_idx[None, :])
    den = b2 - y_idx[:, None] * c2
    py_star = num / _safe(den)
    u_den = c0 + c1 * a_idx[None, :] + c2 * py_star
    u = (a0 + a1 * a_idx[None, :] + a2 * py_star) / _safe(u_den)
    t_img = round_to(_interp(img.contiguous(), u), torch.bfloat16)
    # Pass B: S[py, px] = T[sv(px, py), px] down each output column.
    px = torch.arange(w_o, dtype=torch.float32, device=dev)
    py = torch.arange(h_o, dtype=torch.float32, device=dev)
    den_full = c0 + c1 * px[None, :] + c2 * py[:, None]
    sv = (b0 + b1 * px[None, :] + b2 * py[:, None]) / _safe(den_full)
    s_img = _interp(t_img.transpose(0, 1).contiguous(), sv.T.contiguous())
    s_img = s_img.transpose(0, 1)
    sign_ok = float(np.sign(z_ref - eye[a]) or 1.0)
    valid = (den_full * sign_ok > 0).to(torch.float32)
    rgb = s_img[..., :3] * valid[..., None]
    alpha = torch.clamp(s_img[..., 3] * valid, 0.0, 1.0)
    out_a = alpha
    out = torch.cat([rgb / torch.clamp_min(out_a, 1e-6)[..., None],
                     out_a[..., None]], dim=-1)
    return out.transpose(0, 1) if t_out else out


@torch.no_grad()
def dvr_frame(field: torch.Tensor, cam: dict, lut: torch.Tensor, domain,
              image_size=(1920, 1080), attenuation: float = 100.0,
              scale: float = 1.0, layout_dtype=torch.bfloat16) -> torch.Tensor:
    """``(H, W, 4)`` straight-alpha RGBA over a transparent background of
    the ``(Z, Y, X)`` field seen from ``cam`` (a dict with ``position``,
    ``look_at``, ``up``, ``fovy``, ``z_near``, ``z_far``)."""
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        box_min, box_max = render_box(field.shape)
        eye, a, in_plane, flip = view_axes(cam)
        if not (eye[a] > box_max[a] if flip else eye[a] < box_min[a]):
            raise NotImplementedError("the eye lies inside the slab")
        perm = (_WORLD_TO_ARR[a], _WORLD_TO_ARR[in_plane[1]],
                _WORLD_TO_ARR[in_plane[0]])
        oriented = field.permute(*perm)
        if flip:
            oriented = oriented.flip(0)
        cf = torch.cat([round_to(classify(oriented[s:s + 8], lut, domain),
                                 layout_dtype)
                        for s in range(0, oriented.shape[0], 8)])
        s, nv, nu = cf.shape[:3]
        geo = _geometry(cam, box_min, box_max, a, in_plane, flip, s, nv, nu,
                        image_size, scale, field.device)
        rgb, alpha = _composite(cf, geo, attenuation)
        width, height = image_size
        return _warp(rgb, alpha, cam, width, height, in_plane, a, eye,
                     geo["z_ref"], geo["grid_u_np"], geo["grid_v_np"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior


#: The renderer's settings (``serve.renderer_settings``) this reference
#: draws; any other is refused rather than left out.
SETTINGS = ("attenuation",)


def frame(field: torch.Tensor, cam: dict, lut: torch.Tensor, domain,
          serve: dict, layout_dtype=torch.bfloat16) -> torch.Tensor:
    """The renderer's reference as the check calls it: :func:`dvr_frame`
    with a configuration's ``serve`` settings."""
    settings = dict(serve.get("renderer_settings", {}))
    unknown = set(settings) - set(SETTINGS)
    if unknown:
        raise ValueError(f"the dvr reference draws no {sorted(unknown)}")
    return dvr_frame(field, cam, lut, domain,
                     image_size=tuple(serve["image_size"]),
                     attenuation=float(settings.get("attenuation", 100.0)),
                     scale=float(serve.get("intermediate_scale", 1.0)),
                     layout_dtype=layout_dtype)
