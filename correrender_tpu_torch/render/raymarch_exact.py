"""Exact per-pixel DVR and isosurface frames through the plane-order
marchers (kernels B5 and B6).

Counterpart of ``correrender_tpu/render/raymarch_exact.py``: the Scene's
``quality="exact"`` renderers, and its renderers for frames with a model
matrix, ``nan_mode="yellow"`` or a step size other than 0.1; the
``iso_ray`` renderer takes :func:`iso_render_exact` for every solver
but bisection at fast quality. Samples
follow the reference's DVR shader; the quadrature is plane-anchored with
per-ray step ``Δt = voxel_a/(q·|d_a|)`` (``ops/cuda/raymarch_kernel.py``),
and ``voxel_step`` maps to the sub-step count ``q`` so that the sample
density matches the fixed-step marcher's (0.1 ⇒ q = 10 along the
principal axis).

Routing, decided before any launch and only from the host plan: a DVR
frame the plan rejects (:class:`RaymarchUnsupported`: rays straddling
the principal-axis pole, a transfer function without control points or
with more than 24 knots) or a ``nan_mode`` other than "ignore"/"yellow"
goes to ``render/dvr.py::dvr_render``; an iso frame the plan rejects, or
with ``closed_surface``, goes to ``render/iso.py::iso_render``. A failed
build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.ops.cuda.raymarch_kernel import (
    RaymarchUnsupported,
    dvr_raymarch,
    iso_raymarch,
    model_eye,
    plan_raymarch,
    prepare_raymarch_volume,
    tf_hinges,
)
from correrender_tpu_torch.render.camera import default_render_box
from correrender_tpu_torch.render.dvr import blend_background, dvr_render
from correrender_tpu_torch.render.iso import (
    _refine_and_shade_core,
    iso_render,
    shade_surface,
)


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


def iso_render_exact(
    volume: torch.Tensor,
    camera,
    iso_value: float,
    surface_color=(0.9, 0.4, 0.2, 1.0),
    image_size=(512, 512),
    box=None,
    voxel_step: float = 0.25,
    background=(0.0, 0.0, 0.0, 1.0),
    refine_steps: int = 8,
    intersection_mode: str = "bisection",
    model_matrix=None,
    closed_surface: bool = False,
    return_depth: bool = False,
    prepared: ExactPrepared | None = None,
    on_stage=None,
):
    """Exact isosurface frame: B6 finds each ray's first crossing, then
    the frame is shaded in torch. The same arguments and result as
    :func:`render.iso.iso_render`.

    With "bisection", B6 also refines the crossing and takes the
    gradients, and the frame is shaded from them (the gradients scaled
    per axis by ``±1/|voxel|``, the sign following the slice order).
    Other solvers run B6 without refinement and refine the bracket
    ``[t_hit − Δt, t_hit]`` (``Δt = voxel_a/(q·|d_a|)``) with
    ``render/iso.py``'s solvers. ``prepared`` keeps the marcher layouts
    across frames (shared with :func:`dvr_render_exact`); ``on_stage``,
    as in ``render_correlation_fast``, is called with ``"layout"``,
    ``"march"`` and ``"shade"`` as each stage has been enqueued.
    """

    def fallback():
        return iso_render(
            volume, camera, iso_value, surface_color=surface_color,
            image_size=image_size, box=box, voxel_step=voxel_step,
            background=background, refine_steps=refine_steps,
            intersection_mode=intersection_mode, model_matrix=model_matrix,
            closed_surface=closed_surface, return_depth=return_depth)

    if closed_surface:
        return fallback()
    try:
        plan = plan_raymarch(camera, volume.shape, image_size, box=box,
                             model_matrix=model_matrix)
    except RaymarchUnsupported:
        return fallback()
    plan["q"] = _q_from_voxel_step(plan, voxel_step)
    prep = prepared or ExactPrepared(volume)
    vol_p = prep.get(plan["axis_world"], plan["flip"], plan["lane_axis"])
    hook = on_stage or (lambda name, result: None)
    hook("layout", vol_p)
    in_kernel = int(refine_steps) if intersection_mode == "bisection" else 0
    out = iso_raymarch(vol_p, camera, iso_value, image_size, plan,
                       refine_steps=in_kernel)
    hook("march", out)
    res = shade_from_march(
        out, volume, camera, iso_value, plan, box=box,
        surface_color=surface_color, background=background,
        refine_steps=refine_steps, intersection_mode=intersection_mode,
        return_depth=return_depth)
    hook("shade", res)
    return res


def shade_from_march(out, volume, camera, iso_value, plan, box=None,
                     surface_color=(0.9, 0.4, 0.2, 1.0),
                     background=(0.0, 0.0, 0.0, 1.0), refine_steps: int = 8,
                     intersection_mode: str = "bisection",
                     return_depth: bool = False):
    """The tail of :func:`iso_render_exact`: the frame from B6's six
    outputs ``out`` (or its plain version's) for ``plan``. The frame's
    rays are the march's: ``out``'s unit directions from the model-space
    eye (:func:`model_eye`), so no stage sets them up twice.

    With "bisection", ``out`` holds the refined hits and the gradients
    along the plan's (principal, sub, lane) axes, which are scaled by
    ``±1/|voxel|`` into a world-space normal and shaded. Otherwise ``out``
    holds the crossing samples, and ``render/iso.py``'s solver refines
    ``[t_hit − Δt, t_hit]`` in ``volume``, ``Δt = voxel_a/(q·|d_a|)``.
    """
    directions = out[5]
    a, sub, lane = plan["axis_world"], plan["sub_axis"], plan["lane_axis"]
    voxel = np.abs(plan["voxel"])
    if intersection_mode == "bisection":
        found, t_surf, g_a, g_s, g_l = out[:5]
        comps = [None, None, None]
        comps[a] = g_a * float(np.float32(
            (-1.0 if plan["flip"] else 1.0) / voxel[a]))
        comps[sub] = g_s * float(np.float32(1.0 / voxel[sub]))
        comps[lane] = g_l * float(np.float32(1.0 / voxel[lane]))
        return shade_surface(torch.stack(comps, dim=-1), directions,
                             surface_color, background, found, t_surf,
                             return_depth=bool(return_depth))
    found, t_hit = out[0], out[1]
    origin = torch.as_tensor(model_eye(plan, camera), device=volume.device)
    if box is None:
        box = default_render_box(volume.shape)
    # Δt divided as a tensor: PyTorch turns a Python numerator into a
    # reciprocal and a product.
    dt = torch.as_tensor(np.float32(voxel[a] / plan["q"]),
                         device=volume.device) / torch.clamp_min(
        directions[..., a].abs(), 1e-12)

    def t32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=volume.device)

    return _refine_and_shade_core(
        volume, origin, directions, t32(box[0]), t32(box[1]),
        float(np.float32(iso_value)), surface_color, background,
        torch.where(found, t_hit - dt, 0.0), torch.where(found, t_hit, 1.0),
        found, torch.zeros_like(found), refine_steps=int(refine_steps),
        intersection_mode=str(intersection_mode),
        return_depth=bool(return_depth))
