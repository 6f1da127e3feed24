"""Domain-outline renderer: the AABB wireframe.

Counterpart of ``correrender_tpu/render/outline.py`` (the reference's
DomainOutlineRenderer): the 12 box edges are projected to screen space
on the host and drawn on the device with an analytic distance-to-segment
falloff, as one ``(E, H, W)`` coverage tensor reduced over the edges.
"""

from __future__ import annotations

import numpy as np
import torch


def _project(points, view, proj, width, height):
    """World → pixel coordinates, and the clip-space w."""
    p4 = np.concatenate([points, np.ones((len(points), 1))], axis=-1)
    clip = (proj @ (view @ p4.T)).T
    # w == 0 (a corner in the camera plane) gives inf or NaN here; such
    # edges are masked on the device.
    with np.errstate(divide="ignore", invalid="ignore"):
        ndc = clip[:, :3] / clip[:, 3:4]
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (0.5 - ndc[:, 1] * 0.5) * height
    return np.stack([px, py], axis=-1), clip[:, 3]


_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),
    (4, 5), (5, 7), (7, 6), (6, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def outline_render(camera, box, image_size=(512, 512),
                   color=(1.0, 1.0, 1.0, 1.0), line_width: float = 1.5,
                   base_image=None, return_depth: bool = False,
                   device=None):
    """Draw the box wireframe over ``base_image``, or, without one, as a
    straight-alpha layer on ``device``.

    With ``return_depth`` also returns the ``(H, W)`` eye distance of the
    nearest covered edge (+inf off the wireframe) for the Scene's shared
    depth buffer; an edge's depth interpolates its corners' distances in
    screen space."""
    box_min, box_max = np.asarray(box[0]), np.asarray(box[1])
    corners = np.array(
        [[box_min[0] if i & 1 == 0 else box_max[0],
          box_min[1] if i & 2 == 0 else box_max[1],
          box_min[2] if i & 4 == 0 else box_max[2]] for i in range(8)],
        np.float32)
    width, height = image_size
    view = camera.view_matrix()
    proj = camera.projection_matrix(width / height)
    pts, w_clip = _project(corners, view, proj, width, height)
    eye = np.asarray(camera.position, np.float32)
    corner_depth = np.linalg.norm(corners - eye, axis=-1)
    # Edges with an endpoint behind the camera are masked (no clipping).
    a, b = (np.array(ends) for ends in zip(*_EDGES))
    valid = (w_clip[a] > 0) & (w_clip[b] > 0)
    return _outline_core(pts[a], pts[b], corner_depth[a], corner_depth[b],
                         valid, color, line_width, base_image, width,
                         height, return_depth, device)


def segments_render(camera, p0s, p1s, image_size=(512, 512),
                    color=(1.0, 1.0, 1.0, 1.0), line_width: float = 1.5,
                    base_image=None, return_depth: bool = False,
                    device=None):
    """Draw world-space line segments ``p0s[i] → p1s[i]`` with the
    outline's hairline core (the reference's ConnectingLineRasterPass,
    the line from two selected diagram regions into the 3D view,
    DiagramRenderer.cpp:728-736)."""
    p0s = np.atleast_2d(np.asarray(p0s, np.float32))
    p1s = np.atleast_2d(np.asarray(p1s, np.float32))
    width, height = image_size
    view = camera.view_matrix()
    proj = camera.projection_matrix(width / height)
    pa, w0 = _project(p0s, view, proj, width, height)
    pb, w1 = _project(p1s, view, proj, width, height)
    eye = np.asarray(camera.position, np.float32)
    da = np.linalg.norm(p0s - eye, axis=-1)
    db = np.linalg.norm(p1s - eye, axis=-1)
    return _outline_core(pa, pb, da, db, (w0 > 0) & (w1 > 0), color,
                         line_width, base_image, width, height,
                         return_depth, device)


def connecting_line_points(box_a, box_b):
    """Endpoints of the line between two regions: per axis, each end on
    its box's face toward the other region, or the face midpoint where
    the centres align (HEBChart::getLinePositions, HEBChart.cpp:944-954).
    """
    a_min, a_max = (np.asarray(v, np.float32) for v in box_a)
    b_min, b_max = (np.asarray(v, np.float32) for v in box_b)
    c0 = 0.5 * (a_min + a_max)
    c1 = 0.5 * (b_min + b_max)
    p0 = np.where(c0 < c1, a_max, np.where(c0 > c1, a_min, c0))
    p1 = np.where(c1 < c0, b_max, np.where(c1 > c0, b_min, c1))
    return p0.astype(np.float32), p1.astype(np.float32)


def _outline_core(pa, pb, da, db, valid, color, line_width, base_image,
                  width, height, return_depth, device):
    """Every segment's coverage as one ``(E, H, W)`` tensor, reduced over
    the segments; the host arrays go to the base image's device (or
    ``device``) in float32."""
    if base_image is not None:
        device = base_image.device

    def dev32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    pa, pb, da, db, col = (dev32(x) for x in (pa, pb, da, db, color))
    valid = torch.as_tensor(np.asarray(valid, bool), device=device)
    gy, gx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device) + 0.5,
        torch.arange(width, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")  # (H, W)
    # x and y apart: no (E, H, W, 2) intermediates at 1080p.
    ax, ay = pa[:, 0, None, None], pa[:, 1, None, None]
    abx = (pb[:, 0] - pa[:, 0])[:, None, None]
    aby = (pb[:, 1] - pa[:, 1])[:, None, None]
    denom = torch.clamp_min(abx * abx + aby * aby, 1e-9)
    t = torch.clamp(((gx - ax) * abx + (gy - ay) * aby) / denom, 0.0, 1.0)
    dx = gx - (ax + t * abx)
    dy = gy - (ay + t * aby)
    d = torch.sqrt(dx * dx + dy * dy)
    del dx, dy
    cov_e = torch.clamp(1.0 + float(np.float32(line_width)) * 0.5 - d, 0.0,
                        1.0)
    del d
    # where, not a product: an invalid edge (an endpoint in the camera
    # plane) projects to inf or NaN, and NaN · 0 = NaN would poison every
    # pixel through the max.
    cov_e = torch.where(valid[:, None, None], cov_e, 0.0)
    cov = (cov_e.amax(dim=0) * col[3])[..., None]
    if base_image is None:
        # A layer: straight RGBA, the line colour with coverage in alpha
        # (the depth merge treats every layer as straight alpha).
        img = torch.cat([col[:3].expand(height, width, 3), cov], dim=-1)
    else:
        rgb = cov * col[:3] + (1 - cov) * base_image[..., :3]
        alpha = torch.maximum(cov[..., 0], base_image[..., 3])
        img = torch.cat([rgb, alpha[..., None]], dim=-1)
    if not return_depth:
        return img
    # Every covered pixel carries a depth: an anti-aliased fringe at +inf
    # would sort behind everything.
    ed = da[:, None, None] + t * (db - da)[:, None, None]
    depth = torch.where(cov_e > 0.0, ed, torch.inf).amin(dim=0)
    return img, depth
