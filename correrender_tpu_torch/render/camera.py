"""Perspective camera and ray generation.

Counterpart of ``correrender_tpu/render/camera.py``: rays through pixel
centres in NDC via the inverse projection and view matrices, normalized
in view space (the reference's DvrShader.glsl:75-82). The matrices and
``ray_dirs_affine`` stay float32/float64 numpy on the host; only
:meth:`Camera.rays` builds device tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix (GL convention)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy: float, aspect: float, z_near: float,
                z_far: float) -> np.ndarray:
    """GL-style perspective projection matrix."""
    t = 1.0 / math.tan(fovy * 0.5)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = (z_far + z_near) / (z_near - z_far)
    m[2, 3] = 2.0 * z_far * z_near / (z_near - z_far)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class Camera:
    """Perspective camera; defaults match the reference app's initial view."""

    position: tuple = (0.0, 0.0, 0.8)
    look_at_point: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fovy: float = math.pi / 4.0  # 45°
    z_near: float = 0.001
    z_far: float = 100.0

    def view_matrix(self) -> np.ndarray:
        return look_at(self.position, self.look_at_point, self.up)

    def inverse_view_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.view_matrix()).astype(np.float32)

    def projection_matrix(self, aspect: float) -> np.ndarray:
        return perspective(self.fovy, aspect, self.z_near, self.z_far)

    def inverse_projection_matrix(self, aspect: float) -> np.ndarray:
        return np.linalg.inv(
            perspective(self.fovy, aspect, self.z_near, self.z_far)
        ).astype(np.float32)

    def rays(self, width: int, height: int, device=None):
        """Per-pixel ray origin ``(3,)`` and directions ``(H, W, 3)``.

        Pixel (0, 0) is the top-left of the image (y flipped from GL
        window coordinates so the output array is directly viewable).
        """
        inv_view = torch.as_tensor(self.inverse_view_matrix(), device=device)
        inv_proj = torch.as_tensor(
            self.inverse_projection_matrix(width / height), device=device)
        origin = inv_view[:3, 3]
        px = (torch.arange(width, dtype=torch.float32, device=device)
              + 0.5) / width
        py = (torch.arange(height, dtype=torch.float32, device=device)
              + 0.5) / height
        gy, gx = torch.meshgrid(1.0 - 2.0 * py, 2.0 * px - 1.0,
                                indexing="ij")  # (H, W); row 0 = top
        ones = torch.ones_like(gx)
        t4 = torch.stack([gx, gy, ones, ones], dim=-1)  # NDC z = 1
        view_target = torch.einsum("ij,...j->...i", inv_proj, t4)[..., :3]
        view_dir = view_target / torch.linalg.vector_norm(
            view_target, dim=-1, keepdim=True)
        world_dir = torch.einsum("ij,...j->...i", inv_view[:3, :3], view_dir)
        return origin, world_dir


def rays_in_order(camera: Camera, width: int, height: int, device=None):
    """The rays of :meth:`Camera.rays`, bit for bit alike on every device.

    The pixel centres come from the host; each matrix product is a chain
    of single float32 products and sums in a fixed order (``Camera.rays``'
    ``einsum`` sums in each library's own order), and the norm's square
    root is taken in float64 and rounded once to float32 (correctly
    rounded on both devices). The slice and world-map renderers use
    these rays: a plane hit decides whether a pixel is drawn, and a
    slice's depth clips the DVR, so an ulp of a ray would move a pixel
    across the plane's rim between the card and the CPU.
    """
    f32 = np.float32
    inv_view = camera.inverse_view_matrix()
    inv_proj = camera.inverse_projection_matrix(width / height)

    def centres(count):  # pixel centres in [0, 1]
        return (np.arange(count, dtype=f32) + f32(0.5)) / f32(count)

    gx = torch.as_tensor(f32(2.0) * centres(width) - f32(1.0),
                         device=device).reshape(1, width)
    gy = torch.as_tensor(f32(1.0) - f32(2.0) * centres(height),
                         device=device).reshape(height, 1)
    # NDC (x, y, 1, 1) through the inverse projection.
    vt = [((gx * float(inv_proj[i, 0]) + gy * float(inv_proj[i, 1]))
           + float(inv_proj[i, 2])) + float(inv_proj[i, 3])
          for i in range(3)]
    norm = torch.sqrt(((vt[0] * vt[0] + vt[1] * vt[1]) + vt[2] * vt[2])
                      .to(torch.float64)).to(torch.float32)
    vd = [v / norm for v in vt]
    world = [(vd[0] * float(inv_view[i, 0]) + vd[1] * float(inv_view[i, 1]))
             + vd[2] * float(inv_view[i, 2]) for i in range(3)]
    return (torch.as_tensor(inv_view[:3, 3], device=device),
            torch.stack(world, dim=-1))


def ray_dirs_affine(camera: Camera, width: int, height: int):
    """Affine decomposition of the (unnormalized) ray directions.

    Returns float64 world vectors ``(e0, ex, ey)`` such that the ray
    through pixel ``(px, py)`` (pixel centres, row 0 = top) has direction
    ``d = e0 + ex·px + ey·py`` up to normalization. Used by the matmul
    warp of the shear-warp renderer, where only direction ratios matter.
    """
    inv_view = camera.inverse_view_matrix()
    inv_proj = camera.inverse_projection_matrix(width / height)

    def dir3(px, py):
        x = 2.0 * (px + 0.5) / width - 1.0
        y = 1.0 - 2.0 * (py + 0.5) / height
        view_target = inv_proj @ np.array([x, y, 1.0, 1.0], np.float64)
        return inv_view[:3, :3].astype(np.float64) @ view_target[:3]

    d00 = dir3(0, 0)
    ex = dir3(1, 0) - d00
    ey = dir3(0, 1) - d00
    return d00, ex, ey


def orbit_camera(theta: float, phi: float, radius: float = 0.8,
                 center=(0.0, 0.0, 0.0), **kwargs) -> Camera:
    """Camera on a sphere around ``center``, looking at it (flythrough
    paths)."""
    cx, cy, cz = center
    pos = (
        cx + radius * math.cos(phi) * math.sin(theta),
        cy + radius * math.sin(phi),
        cz + radius * math.cos(phi) * math.cos(theta),
    )
    return Camera(position=pos, look_at_point=center, **kwargs)


def default_render_box(shape_zyx):
    """The default render AABB for a ``(Z, Y, X)`` volume: longest side
    normalized to 0.5 world units, centred at the origin
    (VolumeData.cpp:322-330 convention)."""
    zs, ys, xs = shape_zyx
    dims = np.array(
        [max(xs - 1, 1), max(ys - 1, 1), max(zs - 1, 1)], np.float32
    )
    normalized = dims / dims.max()
    return (-0.25 * normalized, 0.25 * normalized)
