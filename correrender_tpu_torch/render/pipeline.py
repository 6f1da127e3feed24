"""Correlation field → rendered frame.

Counterpart of ``correrender_tpu/render/pipeline.py``. Moving the
reference point re-runs the whole chain on the device: gather the
reference series, the correlation field (K1 for Pearson; B7, B8 and B10
for Spearman, Kendall and KSG), then either the shear-warp renderer (:func:`render_correlation_fast`: classification K2, composite
K3 and the warp) or the fixed-step marcher (:func:`render_correlation`).
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.calculators.correlation import correlate_field
from correrender_tpu_torch.render.camera import default_render_box
from correrender_tpu_torch.render.dvr import (
    dvr_composite,
    num_steps_for,
    world_step_size,
)
from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp


def reference_series(stack: torch.Tensor, ref_point) -> torch.Tensor:
    """The ``(n,)`` member series at voxel ``ref_point = (x, y, z)``.

    A tensor ``ref_point`` (e.g. one a viewer updates on the device) is
    gathered on the device, with no host sync; host ints index directly.
    """
    zs, ys, xs, n = stack.shape
    if isinstance(ref_point, torch.Tensor):
        p = ref_point.to(device=stack.device, dtype=torch.long)
        flat = (p[2] * ys + p[1]) * xs + p[0]
        return stack.reshape(-1, n).index_select(0, flat.reshape(1))[0]
    x, y, z = (int(c) for c in ref_point)
    return stack[z, y, x]


def render_correlation_fast(
    stack: torch.Tensor,
    ref_point,
    camera,
    transfer_function,
    measure="pearson",
    image_size=(512, 512),
    attenuation: float = 100.0,
    background=(0.0, 0.0, 0.0, 1.0),
    intermediate_scale: float = 0.75,
    on_stage=None,
    **measure_kwargs,
) -> torch.Tensor:
    """Correlation field → shear-warp DVR (the interactive fast path).

    Args:
      stack: ``(Z, Y, X, n)`` float32 member stack.
      ref_point: ``(x, y, z)`` voxel indices of the reference point.
      camera, transfer_function: the view; the TF's LUT lies on the
        stack's device.
      on_stage: optional ``on_stage(name, result)`` called as each stage
        has been enqueued: ``"field"`` (the correlation field), then the
        stages of :func:`dvr_shearwarp`. For stage timing.
      measure_kwargs: the measure's settings for :func:`correlate_field`
        (``num_bins``, ``k``, ``kraskov_estimator``, ``absolute``,
        ``mi_bounds``).

    Returns:
      ``(H, W, 4)`` straight-alpha RGBA on the stack's device.
    """
    ref = reference_series(stack, ref_point)
    field = correlate_field(stack, ref, measure, **measure_kwargs)
    if on_stage is not None:
        on_stage("field", field)
    return dvr_shearwarp(
        field,
        camera,
        transfer_function,
        image_size=image_size,
        attenuation=attenuation,
        background=background,
        intermediate_scale=intermediate_scale,
        on_stage=on_stage,
    )


def render_correlation(
    stack: torch.Tensor,
    ref_point,
    camera,
    transfer_function,
    measure="pearson",
    image_size=(512, 512),
    voxel_step: float = 0.1,
    attenuation: float = 100.0,
    background=(0.0, 0.0, 0.0, 1.0),
    **measure_kwargs,
) -> torch.Tensor:
    """Correlation field → the fixed-step DVR marcher
    (:func:`render.dvr.dvr_composite`) over the default render box; see
    :func:`render_correlation_fast` for the shear-warp path.

    Returns:
      ``(H, W, 4)`` straight-alpha RGBA on the stack's device.
    """
    zs, ys, xs, _ = stack.shape
    box_min, box_max = default_render_box((zs, ys, xs))
    step = world_step_size((zs, ys, xs), box_min, box_max, voxel_step)
    width, height = image_size
    origin, directions = camera.rays(width, height, device=stack.device)
    field = correlate_field(stack, reference_series(stack, ref_point),
                            measure, **measure_kwargs)
    return dvr_composite(
        field, origin, directions, box_min, box_max, transfer_function.lut,
        transfer_function.domain, step, attenuation, background,
        num_steps_for(box_min, box_max, step),
    )
