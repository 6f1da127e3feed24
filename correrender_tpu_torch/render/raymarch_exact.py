"""Exact per-pixel DVR through the plane-order marcher (kernel B5).

Counterpart of ``correrender_tpu/render/raymarch_exact.py``: the Scene's
``quality="exact"`` renderer, and its renderer for frames with a model
matrix, ``nan_mode="yellow"`` or a step size other than 0.1. Samples
follow the reference's DVR shader; the quadrature is plane-anchored with
per-ray step ``Δt = voxel_a/(q·|d_a|)`` (``ops/cuda/raymarch_kernel.py``),
and ``voxel_step`` maps to the sub-step count ``q`` so that the sample
density matches the fixed-step marcher's (0.1 ⇒ q = 10 along the
principal axis).

Routing, decided before any launch and only from the host plan: a frame
the plan rejects (:class:`RaymarchUnsupported`: rays straddling the
principal-axis pole, a transfer function without control points or with
more than 24 knots) or a ``nan_mode`` other than "ignore"/"yellow" goes
to ``render/dvr.py::dvr_render``. A failed build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.ops.cuda.raymarch_kernel import (
    RaymarchUnsupported,
    dvr_raymarch,
    plan_raymarch,
    prepare_raymarch_volume,
    tf_hinges,
)
from correrender_tpu_torch.render.dvr import blend_background, dvr_render


class ExactPrepared:
    """Per-``(axis, flip, lane)`` marcher layouts of one volume.

    The layout depends on the camera's principal axis, so an orbiting
    camera can need up to six; entries are built on first use and kept.
    """

    def __init__(self, volume: torch.Tensor):
        self.volume = volume
        self._by_key: dict = {}

    def get(self, axis_world: int, flip: bool,
            lane_axis: int) -> torch.Tensor:
        key = (axis_world, flip, lane_axis)
        if key not in self._by_key:
            self._by_key[key] = prepare_raymarch_volume(
                self.volume, axis_world, flip, lane_axis)
        return self._by_key[key]


def _q_from_voxel_step(plan, voxel_step: float) -> int:
    """Sub-step count matching the fixed-step marcher's density.

    The reference steps ``voxel_step · min(voxel extent)`` in world
    units (DvrRenderer.cpp:363-369); along the principal axis that is
    ``voxel_a / q`` with q below, at most 16 as in the JAX package.
    """
    voxel = plan["voxel"]
    ga = abs(float(voxel[plan["axis_world"]]))
    mn = float(np.min(np.abs(voxel)))
    q = int(round(ga / max(voxel_step * mn, 1e-12)))
    return max(1, min(q, 16))


def dvr_render_exact(
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
    prepared: ExactPrepared | None = None,
) -> torch.Tensor:
    """Exact DVR frame: the same arguments and result as
    :func:`render.dvr.dvr_render` (straight-alpha ``(H, W, 4)`` on the
    volume's device); ``prepared`` keeps the marcher layouts across
    frames."""

    def fallback():
        return dvr_render(
            volume, camera, transfer_function, image_size=image_size,
            box=box, voxel_step=voxel_step, attenuation=attenuation,
            background=background, restriction=restriction,
            model_matrix=model_matrix, nan_mode=nan_mode,
            depth_limit=depth_limit)

    if nan_mode not in ("ignore", "yellow"):
        return fallback()
    try:
        plan = plan_raymarch(camera, volume.shape, image_size, box=box,
                             model_matrix=model_matrix)
        tf_hinges(transfer_function)
    except RaymarchUnsupported:
        return fallback()
    plan["q"] = _q_from_voxel_step(plan, voxel_step)
    prep = prepared or ExactPrepared(volume)
    vol_p = prep.get(plan["axis_world"], plan["flip"], plan["lane_axis"])
    rgb_p, a = dvr_raymarch(
        vol_p, camera, transfer_function, image_size, plan,
        attenuation=attenuation, nan_mode=nan_mode, depth_limit=depth_limit,
        restriction=restriction)
    return blend_background(rgb_p, a, background)


def iso_render_exact(*args, **kwargs):
    """Not ported yet: the exact isosurface marcher (kernel B6)."""
    raise NotImplementedError(
        "iso_render_exact: the iso marcher (kernel B6) is not ported yet "
        "(ROADMAP A.10)")
