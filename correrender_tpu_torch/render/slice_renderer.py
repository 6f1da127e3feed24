"""Slice renderer: transfer-function-mapped planes through the volume.

Counterpart of ``correrender_tpu/render/slice_renderer.py`` (the
reference's SliceRenderer and Slice.glsl): an axis-aligned or oblique
plane (``normal_x/y/z`` + ``plane_dist``, SliceRenderer.cpp:360-368),
Blinn-Phong shading with the plane normal blended by
``lighting_factor`` (Slice.glsl:88), NaN handling ``ignore`` or
``yellow``, and ``fix_on_ground`` (the plane drawn at the domain floor,
sampled at its true position).

* :func:`slice_image` extracts an axis-aligned slice as a 2D image;
* :func:`slice_render_3d` draws the plane into a 3D view by one ray/plane
  intersection a pixel, as torch operations on the volume's device with
  no host sync. The rays (``camera.rays_in_order``), ``t`` and the
  texture coordinates are single float32 operations in the JAX package's
  order, alike on the card and the CPU; XLA contracts some of them into
  fused multiply-adds, so against JAX a pixel on the plane's rim may
  fall on the other side.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.render.camera import (
    default_render_box,
    rays_in_order,
)
from correrender_tpu_torch.render.sampling import sample_trilinear
from correrender_tpu_torch.render.tf import lut_lookup

_AXES = {"x": 0, "y": 1, "z": 2}

#: NaNHandling::NAN_YELLOW (Renderer.hpp NAN_HANDLING_IDS), as the DVR
#: marcher's yellow mode.
_NAN_YELLOW = (1.0, 1.0, 0.0, 1.0)


def _guard(x):
    """|x| < 1e-9 → +1e-9 (the sign is dropped, as in the JAX package)."""
    return torch.where(x.abs() < 1e-9, 1e-9, x)


def _slice3d_core(volume, origin, directions, box_min, box_max, nrm,
                  plane_d, lighting_factor, lut, domain, background,
                  return_depth, nan_yellow, fix_on_ground):
    """The slice frame: plane hit → trilinear sample → LUT → shading →
    composite over ``background``. Every tensor is on the volume's
    device; ``nrm``, ``plane_d``, the box and the domain are float32."""
    if fix_on_ground:
        # Geometry at the domain floor z = zmin (Slice.glsl's vertex
        # stage), the texture sampled at the plane's true height above
        # the same (x, y).
        t = (box_min[2] - origin[2]) / _guard(directions[..., 2])
        pg = origin + directions * t[..., None]
        z_true = (plane_d - nrm[0] * pg[..., 0]
                  - nrm[1] * pg[..., 1]) / _guard(nrm[2])
        p = torch.stack([pg[..., 0], pg[..., 1], z_true], dim=-1)
    else:
        denom = (directions[..., 0] * nrm[0] + directions[..., 1] * nrm[1]
                 + directions[..., 2] * nrm[2])
        t = (plane_d - (origin[0] * nrm[0] + origin[1] * nrm[1]
                        + origin[2] * nrm[2])) / _guard(denom)
        p = origin + directions * t[..., None]
    tex = (p - box_min) / (box_max - box_min)
    in_bounds = ((t > 0) & (tex >= 0.0).all(dim=-1)
                 & (tex <= 1.0).all(dim=-1))
    scalars = sample_trilinear(volume, tex)
    rgba = lut_lookup(lut, domain, scalars)
    fill = (torch.tensor(_NAN_YELLOW, device=rgba.device) if nan_yellow
            else torch.zeros(4, device=rgba.device))
    rgba = torch.where(torch.isnan(scalars)[..., None], fill, rgba)

    # Blinn-Phong with the plane normal, mixed by lighting_factor
    # (Slice.glsl:86-88; the constants of the reference's Lighting.glsl).
    # Headlight: the half vector is the view vector, so diffuse and
    # specular share |n·view| (a two-sided plane).
    view = -directions
    ndv = (view[..., 0] * nrm[0] + view[..., 1] * nrm[1]
           + view[..., 2] * nrm[2]).abs()
    intensity = (0.2 + 0.7 * ndv + 0.1 * ndv ** 32)[..., None]
    shaded = rgba[..., :3] * intensity
    rgb_plane = (rgba[..., :3] * (1.0 - lighting_factor)
                 + shaded * lighting_factor)

    bg = background.expand(rgba.shape)
    mask = (in_bounds.to(torch.float32) * rgba[..., 3])[..., None]
    rgb = mask * rgb_plane + (1 - mask) * bg[..., :3]
    alpha = torch.maximum(mask[..., 0], bg[..., 3])
    img = torch.cat([rgb, alpha[..., None]], dim=-1)
    if return_depth:
        depth = torch.where(in_bounds & (rgba[..., 3] > 0.0), t, torch.inf)
        return img, depth
    return img


def slice_image(volume: torch.Tensor, transfer_function, axis: str = "z",
                position: float = 0.5, resolution=None) -> torch.Tensor:
    """An axis-aligned slice of ``volume`` ``(Z, Y, X)``, TF-mapped to
    ``(H, W, 4)`` RGBA.

    Args:
      axis: "x", "y" or "z" (the slice normal).
      position: normalized [0, 1] position along the axis.
      resolution: optional (W, H) of the output; the grid's by default.
    """
    a = _AXES[axis]
    zs, ys, xs = volume.shape
    w, h = resolution or {0: (ys, zs), 1: (xs, zs), 2: (xs, ys)}[a]
    dev = volume.device
    u = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    gv, gu = torch.meshgrid(v, u, indexing="ij")
    p = torch.full_like(gu, position)
    coords = {0: (p, gu, gv), 1: (gu, p, gv), 2: (gu, gv, p)}[a]
    return transfer_function(sample_trilinear(volume,
                                              torch.stack(coords, dim=-1)))


def slice_render_3d(volume: torch.Tensor, camera, transfer_function,
                    axis: str = "z", position: float = 0.5, normal=None,
                    plane_dist: float | None = None,
                    lighting_factor: float = 0.0,
                    nan_handling: str = "ignore",
                    fix_on_ground: bool = False, image_size=(512, 512),
                    box=None, background=(0.0, 0.0, 0.0, 1.0),
                    return_depth: bool = False):
    """Render the slice plane into a 3D view, on the volume's device.

    The plane is axis-aligned (``axis`` + normalized ``position``) or
    oblique: ``normal=(nx, ny, nz)`` (the reference's ``normal_x/y/z``)
    with the plane ``dot(p, n) == plane_dist`` in world coordinates
    (SliceRenderer.hpp:75-77); without ``plane_dist``, ``position``
    sweeps the plane across the box along ``normal``.
    ``lighting_factor`` mixes Blinn-Phong shading over the flat TF
    colour (the reference's default is 0.5; 0.0 here keeps headless
    renders flat unless asked). ``nan_handling``: "ignore"
    (transparent) or "yellow". ``fix_on_ground`` draws the plane at the
    domain floor while sampling at its true position
    (SliceRenderer.hpp:79).

    With ``return_depth`` also returns the ``(H, W)`` eye distance of the
    plane where it is visibly hit (+inf elsewhere), for the Scene's
    shared depth buffer.
    """
    zs, ys, xs = volume.shape
    if box is None:
        box = default_render_box((zs, ys, xs))
    bmin = np.asarray(box[0], np.float32)
    bmax = np.asarray(box[1], np.float32)
    if normal is not None:
        n = np.asarray(normal, np.float32)
        nn = float(np.linalg.norm(n))
        if nn < 1e-12:
            raise ValueError("slice normal must be non-zero")
        n = n / nn
        if plane_dist is None:
            # Project the box's 8 corners onto n and interpolate.
            corners = np.array(
                [[bx, by, bz]
                 for bx in (bmin[0], bmax[0])
                 for by in (bmin[1], bmax[1])
                 for bz in (bmin[2], bmax[2])], np.float32)
            proj = corners @ n
            d = float(proj.min() + position * (proj.max() - proj.min()))
        else:
            d = float(plane_dist)
    else:
        a = _AXES[axis]
        n = np.zeros(3, np.float32)
        n[a] = 1.0
        d = float(bmin[a] + position * (bmax[a] - bmin[a]))
    if fix_on_ground and abs(float(n[2])) < 1e-6:
        raise ValueError(
            "fix_on_ground needs a plane with a z component "
            "(a vertical plane has no single ground footprint)")
    if nan_handling not in ("ignore", "yellow"):
        raise ValueError(f"nan_handling must be 'ignore' or 'yellow', "
                         f"got {nan_handling!r}")
    dev = volume.device
    width, height = image_size
    origin, directions = rays_in_order(camera, width, height, device=dev)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return _slice3d_core(
        volume, origin, directions, f32(bmin), f32(bmax), f32(n), f32(d),
        float(np.float32(lighting_factor)),
        transfer_function.lut.to(dev), f32(transfer_function.domain),
        f32(background), return_depth, nan_handling == "yellow",
        bool(fix_on_ground))
