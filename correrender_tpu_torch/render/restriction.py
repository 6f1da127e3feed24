"""Render restriction: a ball around the reference point.

Counterpart of ``correrender_tpu/render/restriction.py``. Correlation
calculators can restrict rendering to a ball around their reference
point (the reference's ``setRenderRestrictionData``, consumed per sample
by RenderRestriction.glsl under the Euclidean or Chebyshev distance).
The shear-warp renderer applies it as a voxel mask multiplied into the
classified (premultiplied) volume; the exact marcher tests it per sample.
"""

from __future__ import annotations

import numpy as np
import torch

#: The reference's distance metrics (state-file ``distance_metric``).
DISTANCE_METRIC_NAMES = ("Euclidean", "Chebyshev")


def restriction_center(reference_point, shape_zyx, box) -> np.ndarray:
    """World position ``(3,)`` (float32, xyz) of a reference-point index
    ``(x, y, z)`` in the render box.

    The normalized position is index / (dims − 1) over the box, as the
    reference maps it. This corner convention sits up to half a voxel
    from the voxel centre that :func:`restriction_mask` tests; the
    reference keeps both conventions, and so does the port.
    """
    x, y, z = reference_point
    zs, ys, xs = shape_zyx
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    norm = np.array(
        [x / max(xs - 1, 1), y / max(ys - 1, 1), z / max(zs - 1, 1)],
        np.float32,
    )
    return norm * (box_max - box_min) + box_min


def restriction_mask(shape_zyx, box, center, radius: float,
                     metric: str = "Euclidean",
                     device=None) -> torch.Tensor:
    """``(Z, Y, X)`` float32 mask on ``device``: 1 where the voxel centre
    lies inside the ball, 0 outside."""
    zs, ys, xs = shape_zyx
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    ext = box_max - box_min

    def dist(n, axis):
        c = box_min[axis] + (np.arange(n, dtype=np.float32) + 0.5) / n * ext[
            axis]
        return (torch.as_tensor(c, device=device) - float(center[axis])).abs()

    dz = dist(zs, 2)[:, None, None]
    dy = dist(ys, 1)[None, :, None]
    dx = dist(xs, 0)[None, None, :]
    if metric.lower() == "chebyshev":
        d = torch.maximum(torch.maximum(dx, dy), dz)
    else:
        d = torch.sqrt(dx * dx + dy * dy + dz * dz)
    return (d <= radius).to(torch.float32)


def apply_restriction_rgba(classified: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Zero classified (premultiplied) RGBA outside the mask."""
    return classified * mask[..., None]
