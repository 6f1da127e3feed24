"""Direct volume rendering: the fixed-step ray marcher.

Counterpart of ``correrender_tpu/render/dvr.py``, with the semantics of
the reference's DVR compute shader (DvrShader.glsl:70-140):

* per-pixel rays from the inverse view and projection matrices;
* entry and exit through the slab test; a camera inside the box starts
  the march at the eye;
* a fixed world step of ``voxel_step · min(voxel extent)``
  (DvrRenderer.cpp:363-369, default 0.1);
* per step: trilinear sample → transfer-function LUT →
  ``alpha = 1 − exp(−tf_alpha · Δt · attenuation)`` → front-to-back OVER
  in premultiplied alpha; no early exit (the JAX package masks instead);
* background blend, then un-premultiply.

The JAX package writes this as XLA code (no Pallas kernel), so the port
is plain PyTorch: each step advances all rays of a pass at once. It
serves every frame the exact marcher (B5) and the shear-warp renderer
cannot: cameras inside the volume's slab, unsupported NaN modes,
transfer functions without control points.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from correrender_tpu_torch.render.camera import default_render_box
from correrender_tpu_torch.render.sampling import (
    ray_box_intersect,
    sample_trilinear,
)

# Rays per pass of dvr_render: bounds the per-step temporaries (a few
# dozen floats per ray) to well under a GiB; a 1080p frame is one pass.
_MAX_RAYS_PER_PASS = 1 << 21


def num_steps_for(box_min, box_max, step_size_world: float) -> int:
    """Step count covering the box diagonal."""
    diag = float(np.linalg.norm(np.asarray(box_max) - np.asarray(box_min)))
    return max(int(math.ceil(diag / step_size_world)) + 1, 2)


def world_step_size(grid_shape_zyx, box_min, box_max,
                    voxel_step: float) -> float:
    """stepSize_world = voxel_step · min voxel extent."""
    zs, ys, xs = grid_shape_zyx
    dims = np.asarray(box_max, np.float32) - np.asarray(box_min, np.float32)
    voxel = np.array([dims[0] / xs, dims[1] / ys, dims[2] / zs])
    return float(voxel.min() * voxel_step)


def _f32(x) -> float:
    """A host value rounded to float32, as the JAX package passes it."""
    return float(np.float32(x))


def dvr_composite(
    volume: torch.Tensor,
    origin: torch.Tensor,
    directions: torch.Tensor,
    box_min,
    box_max,
    tf_lut: torch.Tensor,
    tf_domain,
    step_size: float,
    attenuation: float,
    background,
    num_steps: int,
    restriction=None,
    restriction_metric: str = "Euclidean",
    nan_mode: str = "ignore",
    depth_limit=None,
) -> torch.Tensor:
    """The compositing loop. Returns straight-alpha RGBA ``(..., 4)``.

    Args:
      volume: ``(Z, Y, X)`` float32 field.
      origin: ``(3,)`` ray origin; directions: ``(..., 3)`` unit rays.
      box_min, box_max: host ``(3,)`` render box.
      tf_lut: ``(R, 4)`` straight-alpha LUT; tf_domain: host ``(lo, hi)``.
      step_size, attenuation: host floats (world step, coefficient).
      background: host RGBA.
      num_steps: steps from the entry point.
      restriction: optional host ``(cx, cy, cz, radius)``: samples outside
        the ball contribute nothing (RenderRestriction.glsl).
      nan_mode: "ignore" skips NaN samples, "yellow" renders them opaque
        yellow (the reference's NaN debug display).
      depth_limit: optional ``(...)`` world eye distances: samples at or
        beyond them are skipped (the shared per-view depth buffer).
    """
    dev = directions.device

    def t32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    bmin, bmax = t32(box_min), t32(box_max)
    t_near, t_far, hit = ray_box_intersect(origin, directions, bmin, bmax)
    t_start = torch.clamp_min(t_near, 0.0)  # eye inside: start at the eye
    march_len = t_far - t_start

    res = tf_lut.shape[0]
    vmin, vmax = (np.float32(d) for d in tf_domain)
    vspan = float(vmax - vmin)
    vmin = float(vmin)
    extent = bmax - bmin
    step = np.float32(step_size)
    atten = _f32(attenuation)
    nan_fill = t32([1.0, 1.0, 0.0, 1.0] if nan_mode == "yellow"
                   else [0.0, 0.0, 0.0, 0.0])
    if restriction is not None:
        center = t32(restriction[:3])
        radius = _f32(restriction[3])
        chebyshev = restriction_metric.lower() == "chebyshev"

    rgb = torch.zeros(directions.shape[:-1] + (3,), dtype=torch.float32,
                      device=dev)
    a = torch.zeros(directions.shape[:-1], dtype=torch.float32, device=dev)
    for i in range(num_steps):
        dist = float(np.float32(i) * step)  # i · Δt in float32
        t = t_start + dist
        p = origin + directions * t[..., None]
        scalar = sample_trilinear(volume, (p - bmin) / extent)
        u = torch.clamp((scalar - vmin) / vspan, 0.0, 1.0) * (res - 1)
        i0 = torch.clamp(torch.floor(torch.nan_to_num(u)).to(torch.long), 0,
                         res - 2)
        frac = (u - i0)[..., None]
        rgba = tf_lut[i0] * (1.0 - frac) + tf_lut[i0 + 1] * frac
        rgba = torch.where(torch.isnan(scalar)[..., None], nan_fill, rgba)
        alpha = 1.0 - torch.exp(-rgba[..., 3] * float(step) * atten)
        active = hit & (dist < march_len)
        if depth_limit is not None:
            active = active & (t < depth_limit)
        if restriction is not None:
            diff = (p - center).abs()
            if chebyshev:
                d = diff.amax(dim=-1)
            else:
                d = torch.sqrt((diff * diff).sum(dim=-1))
            active = active & (d <= radius)
        alpha = torch.where(active, alpha, 0.0)
        w = (1.0 - a) * alpha  # front-to-back OVER, premultiplied
        rgb = rgb + w[..., None] * rgba[..., :3]
        a = a + w

    return blend_background(rgb, a, background)


def blend_background(rgb: torch.Tensor, alpha: torch.Tensor,
                     background) -> torch.Tensor:
    """Premultiplied ``rgb`` / ``alpha`` OVER the host RGBA background,
    then un-premultiplied: the straight-alpha ``(..., 4)`` frame every DVR
    renderer returns."""
    bg = torch.as_tensor(np.asarray(background, np.float32),
                         device=alpha.device)
    rgb = rgb + (1.0 - alpha)[..., None] * bg[3] * bg[:3]
    alpha = alpha + (1.0 - alpha) * bg[3]
    safe = torch.clamp_min(alpha, 1e-6)
    return torch.cat([rgb / safe[..., None], alpha[..., None]], dim=-1)


def model_inverse(model_matrix, dtype=np.float32):
    """``(m_rot (3, 3), m_trans (3,))`` of the inverse of a 4×4 model
    transform, taken on the host in ``dtype`` as the JAX package takes it
    (float32 in ``dvr_render``, float64 in the exact marcher's plan)."""
    minv = np.linalg.inv(np.asarray(model_matrix, dtype).reshape(4, 4))
    return minv[:3, :3], minv[:3, 3]


def to_model_space(origin, directions, m_rot, m_trans):
    """Rays pulled into model space: ``(m_rot·o + m_trans, m_rot·d)`` in
    float32, as elementwise sums (no matmul, so no TF32 on the card)."""
    rot = torch.as_tensor(np.asarray(m_rot, np.float32),
                          device=directions.device)
    trans = torch.as_tensor(np.asarray(m_trans, np.float32),
                            device=directions.device)
    origin = (rot * origin).sum(dim=-1) + trans
    directions = (rot * directions[..., None, :]).sum(dim=-1)
    return origin, directions


def dvr_render(
    volume: torch.Tensor,
    camera,
    transfer_function,
    image_size=(512, 512),
    box=None,
    voxel_step: float = 0.1,
    attenuation: float = 100.0,
    background=(0.0, 0.0, 0.0, 1.0),
    restriction=None,
    model_matrix=None,
    nan_mode: str = "ignore",
    depth_limit=None,
) -> torch.Tensor:
    """Render a scalar volume with the fixed-step marcher.

    Args:
      volume: ``(Z, Y, X)`` float32 field; the frame is made on its device.
      camera, transfer_function: the view; the TF's LUT lies on the
        volume's device.
      image_size: ``(width, height)``.
      box: optional ``(box_min, box_max)`` render AABB; defaults to the
        normalized ±0.25 box of the volume dims.
      voxel_step: step in voxel units (reference default 0.1).
      restriction: optional ``(center_xyz, radius, metric)``.
      model_matrix: optional 4×4 model transform of the volume: rays are
        pulled into model space with its inverse.
      nan_mode: "ignore" or "yellow".
      depth_limit: optional ``(H, W)`` world eye distances.

    Returns:
      ``(H, W, 4)`` straight-alpha RGBA.
    """
    zs, ys, xs = volume.shape
    if box is None:
        box = default_render_box((zs, ys, xs))
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    step = world_step_size(volume.shape, box_min, box_max, voxel_step)
    steps = num_steps_for(box_min, box_max, step)
    metric = "Euclidean"
    if restriction is not None:
        center, radius, metric = restriction
        restriction = list(np.asarray(center, np.float32)) + [float(radius)]
    width, height = image_size
    dev = volume.device
    origin, directions = camera.rays(width, height, device=dev)
    if model_matrix is not None:
        origin, directions = to_model_space(origin, directions,
                                            *model_inverse(model_matrix))
    dlimit = (None if depth_limit is None else torch.as_tensor(
        depth_limit, dtype=torch.float32, device=dev).reshape(height, width))

    band_h = max(1, _MAX_RAYS_PER_PASS // width)
    bands = []
    for y0 in range(0, height, band_h):
        bands.append(dvr_composite(
            volume, origin, directions[y0:y0 + band_h], box_min, box_max,
            transfer_function.lut, transfer_function.domain, step,
            attenuation, background, steps, restriction=restriction,
            restriction_metric=str(metric), nan_mode=str(nan_mode),
            depth_limit=None if dlimit is None else dlimit[y0:y0 + band_h],
        ))
    return torch.cat(bands, dim=0)
