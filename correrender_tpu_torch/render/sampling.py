"""Volume sampling: trilinear interpolation with GL texture semantics.

Counterpart of ``correrender_tpu/render/sampling.py``: the equivalent of
``texture(sampler3D, texCoords)`` with linear filtering and
clamp-to-edge, as the reference's ray marchers sample. Voxel centres sit
at ``(i + 0.5) / N`` of normalized texture coordinates.
"""

from __future__ import annotations

import torch


def sample_trilinear(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinearly sample ``vol`` at normalized coords.

    Args:
      vol: ``(Z, Y, X)`` scalar volume.
      coords: ``(..., 3)`` normalized texture coordinates in xyz order
        (GLSL ``texture()`` argument order).

    Returns:
      ``(...)`` interpolated values. A NaN voxel anywhere in a sample's
      2×2×2 support makes the sample NaN, as in the JAX package.
    """
    zs, ys, xs = vol.shape
    dims = torch.tensor([xs, ys, zs], dtype=torch.float32, device=vol.device)
    p = coords * dims - 0.5  # voxel-space position, centres at integers
    p0 = torch.floor(p)
    frac = p - p0
    p0 = p0.to(torch.long)
    flat = vol.reshape(-1)

    def gather(ox, oy, oz):
        ix = torch.clamp(p0[..., 0] + ox, 0, xs - 1)
        iy = torch.clamp(p0[..., 1] + oy, 0, ys - 1)
        iz = torch.clamp(p0[..., 2] + oz, 0, zs - 1)
        return flat[(iz * ys + iy) * xs + ix]

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = gather(0, 0, 0) * (1 - fx) + gather(1, 0, 0) * fx
    c10 = gather(0, 1, 0) * (1 - fx) + gather(1, 1, 0) * fx
    c01 = gather(0, 0, 1) * (1 - fx) + gather(1, 0, 1) * fx
    c11 = gather(0, 1, 1) * (1 - fx) + gather(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def sample_nearest(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sampling with clamp-to-edge, at the normalized
    xyz ``coords`` of :func:`sample_trilinear`. The voxel index is
    clamped before the integer cast, so a NaN or infinite coordinate
    reads an edge voxel on every device."""
    zs, ys, xs = vol.shape
    dims = torch.tensor([xs, ys, zs], dtype=torch.float32, device=vol.device)
    p = torch.nan_to_num(torch.floor(coords * dims))

    def index(axis, n):
        return torch.clamp(p[..., axis], 0, n - 1).to(torch.long)

    return vol[index(2, zs), index(1, ys), index(0, xs)]


def ray_box_intersect(origin, direction, box_min, box_max):
    """Slab-method ray/AABB intersection (the reference DVR shader's
    ``rayBoxIntersectionRayCoords``).

    Args:
      origin: ``(3,)`` or ``(..., 3)`` ray origins.
      direction: ``(..., 3)`` ray directions.
      box_min, box_max: ``(3,)`` tensors on the rays' device.

    Returns:
      ``(t_near, t_far, hit)``, each of the batch shape.
    """
    inv_d = 1.0 / direction
    t0 = (box_min - origin) * inv_d
    t1 = (box_max - origin) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = (t_near <= t_far) & (t_far >= 0.0)
    return t_near, t_far, hit
