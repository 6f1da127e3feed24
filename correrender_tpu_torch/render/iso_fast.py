"""Shear-warp isosurface rendering: the first hit per intermediate ray.

Counterpart of ``correrender_tpu/render/iso_fast.py``, the Scene's
default iso renderer for a camera outside the principal-axis slab. The
field's value and world-space gradient are packed as a 4-channel volume
in slice order; each slice is resampled onto the intermediate grid by
two tent-weight matrix products (bf16 operands, float32 sums, as the JAX
package's einsums), and a scan over the slices keeps each intermediate
ray's first iso-crossing, refined linearly between slices (or by a cubic
Hermite with ``refine``). The normal is the interpolated gradient,
shaded Blinn-Phong as ``render/iso.py``, and the intermediate image goes
to the screen through ``dvr_fast.warp_to_screen``.

No TPU kernel stands behind this renderer: the scan is plain torch, one
slice a step, as the JAX package's ``lax.scan`` is plain XLA.

Surfaces are open at the box boundary: the resampling clamps to the
edge and the scan fires only on crossings between in-box samples.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.ops.precision import f32_matmul
from correrender_tpu_torch.render import dvr_fast as df
from correrender_tpu_torch.render.camera import default_render_box
from correrender_tpu_torch.render.iso import _norm, _pow32, iso_render

_EPS = 1e-6


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _gradient_volume(volume: torch.Tensor, box_min, box_max) -> torch.Tensor:
    """Central-difference gradient in world units, ``(Z, Y, X, 3)`` xyz,
    one-sided at the boundary slices."""
    zs, ys, xs = volume.shape
    ext = np.asarray(box_max) - np.asarray(box_min)
    spacing = np.array([ext[0] / xs, ext[1] / ys, ext[2] / zs])

    def diff(axis, h):
        upper = torch.roll(volume, -1, axis)
        lower = torch.roll(volume, 1, axis)
        # Divided by tensors: PyTorch on a GPU divides by a Python number
        # as a product with its reciprocal.
        g = (upper - lower) / _f32(2.0 * h, volume.device)
        n = volume.shape[axis]
        idx = torch.arange(n, device=volume.device).reshape(
            [-1 if a == axis else 1 for a in range(3)])
        h32 = _f32(h, volume.device)
        g = torch.where(idx == 0, (upper - volume) / h32, g)
        return torch.where(idx == n - 1, (volume - lower) / h32, g)

    return torch.stack([diff(2, spacing[0]), diff(1, spacing[1]),
                        diff(0, spacing[2])], dim=-1)


def _tent_bf16(q, coords, step) -> torch.Tensor:
    """bf16-rounded tent weights ``max(1 − |q − c| / step, 0)``, in f32."""
    w = torch.clamp_min(1.0 - (q[:, None] - coords[None, :]).abs() / step,
                        0.0)
    return w.to(torch.bfloat16).to(torch.float32)


def _first_crossing(samples, ts):
    """First sign change over consecutive sample pairs → (crossing?,
    fraction in [0, 1])."""
    crossing = torch.zeros(samples[0].shape, dtype=torch.bool,
                           device=samples[0].device)
    frac = torch.zeros(samples[0].shape, dtype=torch.float32,
                       device=samples[0].device)
    for j in range(len(samples) - 1):
        sj, sk = samples[j], samples[j + 1]
        cj = (sj * sk <= 0.0) & (sj.abs() + sk.abs() > 0.0)
        d = sj - sk
        sub = sj / torch.where(d.abs() < _EPS, _EPS, d)
        fj = ts[j] + (ts[j + 1] - ts[j]) * torch.clamp(sub, 0.0, 1.0)
        frac = torch.where(cj & ~crossing, fj, frac)
        crossing = crossing | cj
    return crossing, frac


def _first_hit_scan(cvol, g, coords_v, coords_u, grid_v, grid_u, eye_uv,
                    iso_value: float, ip0: int = 0, ip1: int = 1,
                    ax: int = 2, ds: float = 0.0, refine: int = 0):
    """First iso-crossing per intermediate ray.

    Args:
      cvol: ``(S, Yv, Xv, 4)`` [value, gx, gy, gz] slices, near → far.
      g: ``(S,)`` per-slice projection scales (host).
      coords_v, coords_u: voxel-centre world coordinates along v and u.
      grid_v, grid_u: the intermediate grid's world coordinates.
      eye_uv: the eye's in-plane (u, v).
      ip0, ip1, ax: world axes of u, v and the slices; ``ds`` the signed
        world step between slices (for ``refine``).
      refine: Hermite sub-slab samples between planes (0: linear).

    Returns:
      ``(found, depth, grad)``: ``(hi, wi)`` bool, the fractional slice
      index of the hit, and the ``(hi, wi, 3)`` f32 gradient there.
    """
    dev = cvol.device
    s, yv, xv, _ = cvol.shape
    cy = _f32(coords_v, dev)
    cx = _f32(coords_u, dev)
    gv = _f32(grid_v, dev)
    gu = _f32(grid_u, dev)
    hi, wi = gv.shape[0], gu.shape[0]
    dy = cy[1] - cy[0] if yv > 1 else _f32(1.0, dev)
    dx = cx[1] - cx[0] if xv > 1 else _f32(1.0, dev)
    y0, y1 = cy[0], cy[-1]
    x0, x1 = cx[0], cx[-1]
    e_u, e_v = _f32(eye_uv[0], dev), _f32(eye_uv[1], dev)
    g32 = np.asarray(g, np.float32)
    iso = float(np.float32(iso_value))

    found = torch.zeros((hi, wi), dtype=torch.bool, device=dev)
    depth = torch.zeros((hi, wi), dtype=torch.float32, device=dev)
    grad = torch.zeros((hi, wi, 3), dtype=torch.float32, device=dev)
    prev_val = torch.zeros((hi, wi), dtype=torch.float32, device=dev)
    prev_grad = torch.zeros((hi, wi, 3), dtype=torch.float32, device=dev)
    prev_in = torch.zeros((hi, wi), dtype=torch.bool, device=dev)
    prev_gk = np.float32(0.0)
    with f32_matmul():
        for k in range(s):
            gk = g32[k]
            gk_t = _f32(gk, dev)
            qv = e_v + (gv - e_v) * gk_t
            qu = e_u + (gu - e_u) * gk_t
            in_v = (qv >= y0) & (qv <= y1)
            in_u = (qu >= x0) & (qu <= x1)
            wv = _tent_bf16(torch.clamp(qv, y0, y1), cy, dy)  # (hi, yv)
            wu = _tent_bf16(torch.clamp(qu, x0, x1), cx, dx)  # (wi, xv)
            slice_c = cvol[k].to(torch.bfloat16).to(torch.float32)
            slab = (wv @ slice_c.reshape(yv, xv * 4)).to(
                torch.bfloat16).to(torch.float32)  # (hi, xv·4)
            # (hi·4, xv) @ (xv, wi): one product over every row and channel.
            out = (slab.reshape(hi, xv, 4).transpose(1, 2).reshape(
                hi * 4, xv) @ wu.T).reshape(hi, 4, wi)
            cur = out[:, 0] - iso
            # bf16 gradient carries, as in the JAX package.
            cur_grad = out[:, 1:].permute(0, 2, 1).to(torch.bfloat16).to(
                torch.float32)
            inside = in_v[:, None] & in_u[None, :] & bool(gk > _EPS)
            if refine > 0:
                dgk = gk_t - _f32(prev_gk, dev)
                du = (gu[None, :] - e_u) * dgk
                dv = (gv[:, None] - e_v) * dgk
                d0 = (prev_grad[..., ip0] * du + prev_grad[..., ip1] * dv
                      + prev_grad[..., ax] * ds)
                d1 = (cur_grad[..., ip0] * du + cur_grad[..., ip1] * dv
                      + cur_grad[..., ax] * ds)
                samples, ts = [prev_val], [0.0]
                for j in range(1, refine + 1):
                    t = j / (refine + 1.0)
                    h00 = (1 + 2 * t) * (1 - t) ** 2
                    h10 = t * (1 - t) ** 2
                    h01 = t * t * (3 - 2 * t)
                    h11 = t * t * (t - 1)
                    samples.append(h00 * prev_val + h10 * d0 + h01 * cur
                                   + h11 * d1)
                    ts.append(t)
                samples.append(cur)
                ts.append(1.0)
                crossed, frac = _first_crossing(samples, ts)
            else:
                crossed, frac = _first_crossing([prev_val, cur], [0.0, 1.0])
            newly = crossed & inside & prev_in & ~found if k > 0 else None
            if newly is not None:
                depth = torch.where(newly, (k - 1) + frac, depth)
                lerped = (prev_grad * (1.0 - frac)[..., None]
                          + cur_grad * frac[..., None])
                grad = torch.where(newly[..., None],
                                   lerped.to(torch.bfloat16).to(
                                       torch.float32), grad)
                found = found | newly
            prev_val, prev_grad, prev_in, prev_gk = cur, cur_grad, inside, gk
    return found, depth, grad


def _axial_interleave(cvol: torch.Tensor, m: int) -> torch.Tensor:
    """m× axial supersampling with exact trilinear sub-slabs: the field
    at a fractional slice position is the lerp of the bracketing planes
    at the same (u, v)."""
    base, nxt = cvol[:-1], cvol[1:]
    subs = [(1.0 - j / m) * base + (j / m) * nxt for j in range(m)]
    body = torch.stack(subs, dim=1).reshape((-1,) + tuple(cvol.shape[1:]))
    return torch.cat([body, cvol[-1:]], dim=0)


def prepare_iso_shearwarp(volume: torch.Tensor, camera, box=None,
                          axial_supersample: int = 1) -> dict:
    """The resident first-hit volume of a field for a camera: value and
    world-space gradient in (slice, v, u, 4) near → far order, axially
    interleaved when ``axial_supersample > 1``. It changes only with the
    field or when the camera crosses an axis or order boundary; pass it
    to :func:`iso_shearwarp` as ``prepared=`` (rebuilt there on a
    mismatch)."""
    if box is None:
        box = default_render_box(volume.shape)
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    _, a, in_plane, flip = df.shearwarp_axes(camera)
    grad = _gradient_volume(volume, box_min, box_max)
    cvol = torch.cat([volume[..., None], grad], dim=-1)
    cvol = cvol.permute(*df.slice_perm(a, in_plane), 3)
    if flip:
        cvol = cvol.flip(0)
    cvol = cvol.contiguous()
    n_base = cvol.shape[0]
    m = int(axial_supersample)
    if m > 1 and n_base > 1:
        cvol = _axial_interleave(cvol, m)
    return {"key": (a, flip, m), "cvol": cvol, "n_base": n_base}


def iso_shearwarp(
    volume: torch.Tensor,
    camera,
    iso_value: float,
    surface_color=(0.9, 0.4, 0.2, 1.0),
    image_size=(1920, 1080),
    box=None,
    background=(0.0, 0.0, 0.0, 1.0),
    intermediate_scale: float = 1.0,
    prepared: dict | None = None,
    return_depth: bool = False,
    refine: int = 0,
    axial_supersample: int = 1,
    on_stage=None,
):
    """Fast isosurface frame of a ``(Z, Y, X)`` float32 field (see the
    module docstring): ``(H, W, 4)`` straight-alpha RGBA on the field's
    device and, with ``return_depth``, the ``(H, W)`` eye distance of the
    first hit (+inf where none). A camera inside or past the near face of
    the principal-axis slab renders with ``render/iso.py::iso_render``.
    ``on_stage``, as in ``dvr_shearwarp``, is called with ``"prepare"``,
    ``"scan"`` (``(found, depth, grad, geometry)``) and ``"warp"``."""
    if box is None:
        box = default_render_box(volume.shape)
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    eye, a, in_plane, flip = df.shearwarp_axes(camera)
    if not df.shearwarp_viable(camera, (box_min, box_max)):
        return iso_render(volume, camera, iso_value,
                          surface_color=surface_color, image_size=image_size,
                          box=box, background=background,
                          return_depth=return_depth)
    stage = on_stage or (lambda name, result: None)
    m = int(axial_supersample)
    if prepared is None or prepared["key"] != (a, flip, m):
        prepared = prepare_iso_shearwarp(volume, camera, box=box,
                                         axial_supersample=m)
    stage("prepare", prepared)
    cvol, n_base = prepared["cvol"], prepared["n_base"]
    nv, nu = cvol.shape[1], cvol.shape[2]

    # The geometry of the original planes; the supersampled slice
    # coordinates and scales follow by exact subdivision (g is affine in
    # the slice coordinate).
    geo = df.shearwarp_geometry(camera, box_min, box_max, a, in_plane, flip,
                                n_base, nv, nu, image_size,
                                intermediate_scale, device=volume.device)
    slice_coords = geo["slice_coords"]
    if m > 1 and n_base > 1:
        n_slices = (n_base - 1) * m + 1
        step0 = (slice_coords[1] - slice_coords[0]) / m
        slice_coords = slice_coords[0] + np.arange(n_slices) * step0
        g0 = geo["g"]
        geo = dict(geo, g=g0[0] + np.arange(n_slices) * ((g0[1] - g0[0]) / m))
    assert cvol.shape[0] == len(geo["g"])
    z_ref, e_u, e_v = geo["z_ref"], geo["e_u"], geo["e_v"]
    grid_u, grid_v = geo["grid_u"], geo["grid_v"]
    width, height = image_size
    ds_world = (float(slice_coords[1] - slice_coords[0])
                if len(slice_coords) > 1 else 0.0)
    found, depth, grad_hit = _first_hit_scan(
        cvol, geo["g"], geo["coords_v"], geo["coords_u"], grid_v, grid_u,
        (e_u, e_v), iso_value, ip0=in_plane[0], ip1=in_plane[1], ax=a,
        ds=float(np.float32(ds_world)), refine=int(refine))
    stage("scan", (found, depth, grad_hit, geo))
    img = shade_and_warp(found, grad_hit, camera, grid_u, grid_v, in_plane,
                         a, eye, z_ref, surface_color, background, width,
                         height)
    stage("warp", img)
    if not return_depth:
        return img

    # Eye distance on the intermediate grid: the ray through (u, v)
    # passes (grid_u[u], grid_v[v]) on the z_ref plane, so a hit at slice
    # coordinate s lies |s − e_a| / |z_ref − e_a| of that distance away.
    step_slice = (float(slice_coords[1] - slice_coords[0])
                  if len(slice_coords) > 1 else 1.0)
    dev = volume.device
    e_a = eye[a]
    s_hit = _f32(slice_coords[0], dev) + depth * _f32(step_slice, dev)
    du = _f32(grid_u, dev)[None, :] - _f32(e_u, dev)
    dv = _f32(grid_v, dev)[:, None] - _f32(e_v, dev)
    dz = _f32(z_ref - e_a, dev)
    ref_len = torch.sqrt(du * du + dv * dv + dz * dz)
    dist = torch.where(found,
                       (s_hit - _f32(e_a, dev)).abs() / dz.abs() * ref_len,
                       0.0)
    # The depth rides channel 0 with coverage as alpha through the same
    # homography (warp_to_screen un-premultiplies it).
    zeros = torch.zeros_like(dist)
    dimg = df.warp_to_screen(
        torch.stack([dist, zeros, zeros], dim=-1), found.to(torch.float32),
        camera, width, height, in_plane, a, eye, z_ref, grid_u, grid_v,
        (0.0, 0.0, 0.0, 0.0))
    screen_depth = torch.where(dimg[..., 3] > 0.5, dimg[..., 0], torch.inf)
    return img, screen_depth


def _shade_intermediate(found, grad_hit, grid_u, grid_v, e_u, e_v, dz, col,
                        ip0, ip1, a):
    """Blinn-Phong shading of a first-hit map on the intermediate grid:
    premultiplied rgb and coverage."""
    dev = grad_hit.device
    gu = _f32(grid_u, dev)
    gv = _f32(grid_v, dev)
    shape2 = (gv.shape[0], gu.shape[0])
    d3 = torch.zeros(shape2 + (3,), dtype=torch.float32, device=dev)
    d3[..., ip0] = (gu[None, :] - _f32(e_u, dev)).expand(shape2)
    d3[..., ip1] = (gv[:, None] - _f32(e_v, dev)).expand(shape2)
    d3[..., a] = _f32(dz, dev)
    d3 = d3 / torch.clamp_min(_norm(d3), 1e-9)
    n_vec = grad_hit / torch.clamp_min(_norm(grad_hit), 1e-9)
    view = -d3
    n_facing = torch.where((n_vec * view).sum(-1, keepdim=True) < 0,
                           -n_vec, n_vec)
    light = view  # a headlight, as render/iso.py
    diffuse = 0.7 * (n_facing * light).sum(-1).abs()
    half_v = (light + view) / torch.clamp_min(_norm(light + view), 1e-9)
    spec = 0.1 * _pow32((n_facing * half_v).sum(-1).abs())
    intensity = (0.2 + diffuse + spec)[..., None]
    found_f = found.to(torch.float32)
    col3 = _f32(np.asarray(col, np.float32)[:3], dev)
    return found_f[..., None] * col3 * intensity, found_f


def shade_and_warp(found, grad_hit, camera, grid_u, grid_v, in_plane, a,
                   eye, z_ref, surface_color, background, width, height):
    """Shade a first-hit map on the intermediate grid and warp it to the
    screen."""
    e_u, e_v = eye[in_plane[0]], eye[in_plane[1]]
    inter_rgb, inter_a = _shade_intermediate(
        found, grad_hit, grid_u, grid_v, e_u, e_v, z_ref - eye[a],
        surface_color, in_plane[0], in_plane[1], a)
    return df.warp_to_screen(inter_rgb, inter_a, camera, width, height,
                             in_plane, a, eye, z_ref, grid_u, grid_v,
                             background)
