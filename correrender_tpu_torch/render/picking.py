"""Reference-point picking and the reference-point marker.

Counterpart of ``correrender_tpu/render/picking.py`` (the reference's
PointPicker and ReferencePointSelectionRenderer): picking the
correlation reference point under a pixel (ray → voxel, or the fixed
z-plane mode), scrubbing the focus along the pick ray, and the marker
disc with its shadow rim drawn into a view (VolumeData.cpp:1948). The
picking runs on the host; :func:`render_reference_point_marker` draws on
the base image's device.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.render.sampling import ray_box_intersect


def _pick_ray(camera, pixel_xy, image_size):
    """The host origin and direction (float32) of the ray through a
    pixel, from :meth:`Camera.rays` on the CPU."""
    width, height = image_size
    origin, dirs = camera.rays(width, height)
    px, py = int(pixel_xy[0]), int(pixel_xy[1])
    return origin.numpy(), dirs[py, px].numpy()


def _box_hit(o, d, box_min, box_max):
    """(t_near, t_far) of the float32 ray against the box, or None."""
    def t32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    t_near, t_far, hit = ray_box_intersect(t32(o), t32(d[None, None]),
                                           t32(box_min), t32(box_max))
    if not bool(hit[0, 0]):
        return None
    return float(t_near[0, 0]), float(t_far[0, 0])


def _fixed_z_hit(o, d, box_min, box_max, fixed_z_fraction):
    """Where the ray meets the plane at ``fixed_z_fraction`` of the box's
    z extent inside the box's (x, y) footprint, or None."""
    z_plane = box_min[2] + fixed_z_fraction * (box_max[2] - box_min[2])
    if abs(d[2]) < 1e-12:
        return None
    t = (z_plane - o[2]) / d[2]
    if t <= 0:
        return None
    p = o + d * t
    if not (box_min[0] <= p[0] <= box_max[0]
            and box_min[1] <= p[1] <= box_max[1]):
        return None
    return p


def pick_voxel(camera, pixel_xy, image_size, grid_shape_zyx, box,
               fixed_z_fraction: float | None = None):
    """The ``(x, y, z)`` voxel under a pixel (origin top-left), or None
    if the ray misses. ``fixed_z_fraction`` intersects the plane at that
    normalized world z instead of the box's entry face (the reference's
    ``fixPickingZPlane``, CorrelationCalculator.hpp:130-133)."""
    o, d = _pick_ray(camera, pixel_xy, image_size)
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    if fixed_z_fraction is not None:
        p = _fixed_z_hit(o, d, box_min, box_max, fixed_z_fraction)
        if p is None:
            return None
    else:
        hit = _box_hit(o, d, box_min, box_max)
        if hit is None:
            return None
        p = o + d * max(hit[0], 0.0)
    return world_to_voxel(p, grid_shape_zyx, box)


def world_to_voxel(p, grid_shape_zyx, box):
    """World point → voxel index under the cell-centre convention the
    renderers use (``(idx + 0.5) / dims``; the reference rounds to node
    coordinates, PointPicker.cpp:142-151, a half-voxel convention applied
    alike on both sides here)."""
    zs, ys, xs = grid_shape_zyx
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    tex = (np.asarray(p, np.float32) - box_min) / (box_max - box_min)
    vox = np.floor(tex * np.array([xs, ys, zs])).astype(int)
    vox = np.clip(vox, 0, np.array([xs - 1, ys - 1, zs - 1]))
    return int(vox[0]), int(vox[1]), int(vox[2])


def pick_hit_points(camera, pixel_xy, image_size, box,
                    fixed_z_fraction: float | None = None):
    """The pick ray's ``first``, ``last``, ``direction`` and ``focus``
    world points (float64), or None if it misses: what the reference keeps
    from its last pick to scrub the focus through the volume with the
    scroll wheel (PointPicker.cpp:88-135). In the fixed z-plane mode the
    scrub runs along the world z column through the hit, following the
    pick ray's z sign (PointPicker.cpp:96-100)."""
    width, height = image_size
    pixel_xy = (max(0, min(width - 1, int(pixel_xy[0]))),
                max(0, min(height - 1, int(pixel_xy[1]))))
    o, d = _pick_ray(camera, pixel_xy, image_size)
    o, d = o.astype(np.float64), d.astype(np.float64)
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    if fixed_z_fraction is not None:
        p = _fixed_z_hit(o, d, box_min, box_max, fixed_z_fraction)
        if p is None:
            return None
        # first: the z face the ray crosses first; last: the far one, so
        # the scrub_focus clamp stays in the box for cameras above or
        # below the volume.
        sz = 1.0 if d[2] > 0 else -1.0
        near_z, far_z = ((box_min[2], box_max[2]) if sz > 0
                         else (box_max[2], box_min[2]))
        first = np.array([p[0], p[1], near_z], np.float64)
        last = np.array([p[0], p[1], far_z], np.float64)
        direction = np.array([0.0, 0.0, sz], np.float64)
        focus = p
    else:
        hit = _box_hit(o, d, box_min, box_max)
        if hit is None:
            return None
        first = o + d * max(hit[0], 0.0)
        last = o + d * hit[1]
        norm = np.linalg.norm(d)
        direction = d / (norm if norm > 0 else 1.0)
        focus = first
    return {"first": first, "last": last, "direction": direction,
            "focus": focus}


def scrub_focus(hit: dict, amount: float) -> dict:
    """Move the focus ``amount`` world units along the pick ray, clamped
    between ``first`` and ``last`` (PointPicker.cpp:128-134). Mutates and
    returns ``hit``."""
    first = np.asarray(hit["first"], np.float64)
    last = np.asarray(hit["last"], np.float64)
    direction = np.asarray(hit["direction"], np.float64)
    new_focus = np.asarray(hit["focus"], np.float64) + amount * direction
    t = float(np.dot(new_focus - first, direction))
    t = min(max(t, 0.0), float(np.linalg.norm(last - first)))
    hit["focus"] = first + t * direction
    return hit


def marker_screen_center(camera, reference_point_xyz, grid_shape_zyx, box,
                         image_size):
    """The pixel ``(cx, cy)`` of a reference voxel's centre; None behind
    the camera."""
    width, height = image_size
    zs, ys, xs = grid_shape_zyx
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    x, y, z = reference_point_xyz
    world = box_min + (np.array([x + 0.5, y + 0.5, z + 0.5])
                       / np.array([xs, ys, zs])) * (box_max - box_min)
    view = camera.view_matrix()
    proj = camera.projection_matrix(width / height)
    clip = proj @ (view @ np.append(world, 1.0))
    if clip[3] <= 0:
        return None
    ndc = clip[:3] / clip[3]
    return (float((ndc[0] * 0.5 + 0.5) * width),
            float((0.5 - ndc[1] * 0.5) * height))


def overlay_reference_point_marker_np(arr: np.ndarray, camera,
                                      reference_point_xyz, grid_shape_zyx,
                                      box, color=(1.0, 0.1, 0.1, 1.0),
                                      radius_px: float = 6.0):
    """Draw the marker in place into a host float RGBA image, over the
    disc's window only."""
    h, w = arr.shape[:2]
    center = marker_screen_center(camera, reference_point_xyz,
                                  grid_shape_zyx, box, (w, h))
    if center is None:
        return arr
    cx, cy = center
    r = radius_px + 3.0
    x0 = int(max(0, np.floor(cx - r)))
    x1 = int(min(w, np.ceil(cx + r)))
    y0 = int(max(0, np.floor(cy - r)))
    y1 = int(min(h, np.ceil(cy + r)))
    if x0 >= x1 or y0 >= y1:
        return arr
    gx, gy = np.meshgrid(np.arange(x0, x1, dtype=np.float32) + 0.5,
                         np.arange(y0, y1, dtype=np.float32) + 0.5)
    dist = np.hypot(gx - cx, gy - cy)
    disc = np.clip(radius_px + 0.5 - dist, 0.0, 1.0)
    rim = np.clip(radius_px + 2.5 - dist, 0.0, 1.0) - disc
    col = np.asarray(color, np.float32)
    a = (disc * col[3] + rim * 0.5)[..., None]
    win = arr[y0:y1, x0:x1]
    win[..., :3] = disc[..., None] * col[:3] + (1 - a) * win[..., :3]
    win[..., 3] = np.maximum(a[..., 0], win[..., 3])
    return arr


def render_reference_point_marker(camera, reference_point_xyz,
                                  grid_shape_zyx, box,
                                  image_size=(512, 512),
                                  color=(1.0, 0.1, 0.1, 1.0),
                                  radius_px: float = 6.0, base_image=None,
                                  device=None):
    """Draw the reference-point marker over a view: a screen-space disc
    with a shadow rim (ShadowCircleRasterPass), on the base image's
    device (or ``device`` for a new transparent image)."""
    width, height = image_size
    if base_image is not None:
        device = base_image.device
    else:
        base_image = torch.zeros((height, width, 4), dtype=torch.float32,
                                 device=device)
    center = marker_screen_center(camera, reference_point_xyz,
                                  grid_shape_zyx, box, image_size)
    if center is None:
        return base_image
    cx, cy = center
    gy, gx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device) + 0.5,
        torch.arange(width, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")
    dist = torch.sqrt((gx - cx) ** 2 + (gy - cy) ** 2)
    disc = torch.clamp(radius_px + 0.5 - dist, 0.0, 1.0)
    rim = torch.clamp(radius_px + 2.5 - dist, 0.0, 1.0) - disc  # shadow
    col = torch.as_tensor(np.asarray(color, np.float32), device=device)
    a = (disc * col[3] + rim * 0.5)[..., None]
    rgb = disc[..., None] * col[:3]  # the rim stays black
    out_rgb = rgb + (1 - a) * base_image[..., :3]
    out_a = torch.maximum(a[..., 0], base_image[..., 3])
    return torch.cat([out_rgb, out_a[..., None]], dim=-1)
