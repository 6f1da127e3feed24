"""Isosurface ray casting: the fixed-step marcher, hit refinement and
shading.

Counterpart of ``correrender_tpu/render/iso.py``, with the semantics of
the reference's IsoSurfaceRayCasting shader: fixed-step marching with
sign-change detection, hit refinement by one of the reference's
intersection solvers ("linear", "bisection", "marmitt" or the analytic
cubic root), central-difference normals and Blinn-Phong shading with a
headlight (Lighting.glsl defaults).

The JAX package writes this as XLA code (no Pallas kernel), so the port
is plain PyTorch. ``iso_render`` is the renderer for every frame the
exact marcher (kernel B6, ``render/raymarch_exact.py``) does not take:
closed surfaces and cameras the plan refuses. It renders a frame in one
pass: the JAX package's ``max_rays_per_pass`` row bands worked around a
crash of a remote TPU worker and are not carried over.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from correrender_tpu_torch.render.camera import default_render_box
from correrender_tpu_torch.render.dvr import (
    model_inverse,
    num_steps_for,
    to_model_space,
    world_step_size,
)
from correrender_tpu_torch.render.sampling import (
    ray_box_intersect,
    sample_trilinear,
)

SOLVERS = ("linear", "bisection", "marmitt", "analytic")


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root, rounded once to float32 as ``jnp.cbrt`` is (torch
    has no cbrt; a float32 ``pow(x, 1/3)`` is off by its rounded
    exponent, which Cardano's cancellation amplifies)."""
    return (torch.sign(x) * x.abs().double().pow(1.0 / 3.0)).to(x.dtype)


def _smallest_cubic_root01(f0, f1, f2, f3):
    """Smallest root in [0, 1] of the cubic through samples at τ = 0,
    1/3, 2/3, 1 (vectorized Cardano / trigonometric solver), NaN where no
    root lies in [0, 1].

    The trilinear interpolant along a ray segment inside one cell is
    exactly cubic, so this is the reference's analytic intersection
    option (IsoSurfaceRayCasting.glsl:34-36,185). Falls back to the
    quadratic and linear roots where the leading coefficients vanish.
    """
    a = 4.5 * (-f0 + 3.0 * f1 - 3.0 * f2 + f3)
    b = 4.5 * (2.0 * f0 - 5.0 * f1 + 4.0 * f2 - f3)
    c = 0.5 * (-11.0 * f0 + 18.0 * f1 - 9.0 * f2 + 2.0 * f3)
    d = f0
    tiny = 1e-7
    nan = torch.full_like(f0, math.nan)

    def pick(*roots):
        best = torch.full_like(f0, math.inf)
        for r in roots:
            ok = torch.isfinite(r) & (r >= -1e-4) & (r <= 1.0 + 1e-4)
            best = torch.where(ok & (r < best), r, best)
        return torch.where(torch.isfinite(best), torch.clamp(best, 0.0, 1.0),
                           nan)

    # Linear: c τ + d = 0.
    lin = torch.where(c.abs() > tiny, -d / c, nan)
    # Quadratic: b τ² + c τ + d = 0.
    disc_q = c * c - 4.0 * b * d
    sq = torch.sqrt(torch.clamp_min(disc_q, 0.0))
    bq = torch.where(b.abs() > tiny, b, 1.0)
    q1 = (-c - sq) / (2.0 * bq)
    q2 = (-c + sq) / (2.0 * bq)
    quad_valid = disc_q >= 0.0
    quad = pick(torch.where(quad_valid, q1, nan),
                torch.where(quad_valid, q2, nan))
    # Cubic, depressed: s = τ + b/(3a); s³ + p s + q = 0.
    an = torch.where(a.abs() > tiny, a, 1.0)
    bn, cn, dn = b / an, c / an, d / an
    p = cn - bn * bn / 3.0
    q = 2.0 * (bn * bn * bn) / 27.0 - bn * cn / 3.0 + dn
    shift = -bn / 3.0
    q2h, p3 = q / 2.0, p / 3.0
    disc = q2h * q2h + p3 * p3 * p3
    # One real root (disc > 0): Cardano.
    sd = torch.sqrt(torch.clamp_min(disc, 0.0))
    r_single = _cbrt(-q / 2.0 + sd) + _cbrt(-q / 2.0 - sd) + shift
    # Three real roots (disc <= 0): trigonometric.
    pm = torch.clamp_max(p, -tiny)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    r0 = m * torch.cos(theta) + shift
    r1 = m * torch.cos(theta - 2.0 * math.pi / 3.0) + shift
    r2 = m * torch.cos(theta - 4.0 * math.pi / 3.0) + shift
    single = disc > 0.0
    cub = pick(torch.where(single, r_single, r0),
               torch.where(single, nan, r1),
               torch.where(single, nan, r2))
    return torch.where(a.abs() > tiny, cub,
                       torch.where(b.abs() > tiny, quad, pick(lin)))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def _pow32(x: torch.Tensor) -> torch.Tensor:
    """x³² by five squarings, as XLA's integer power computes it."""
    for _ in range(5):
        x = x * x
    return x


def shade_surface(n, directions, surface_color, background, found, t_surf,
                  light_dir=None, return_depth=False):
    """Blinn-Phong shading of the hit points (Lighting.glsl defaults:
    ambient 0.2, diffuse 0.7, specular 0.1 with exponent 32).

    ``n``: ``(H, W, 3)`` surface normals (need not be normalized);
    ``directions``: the unit rays; ``found``: ``(H, W)`` hit mask;
    ``t_surf``: hit distances. ``surface_color`` and ``background`` are
    host RGBA values. Returns the straight-alpha ``(H, W, 4)`` image and,
    with ``return_depth``, the eye distance of each hit (+inf where none).
    """
    dev = directions.device
    n = n / torch.clamp_min(_norm(n), 1e-9)
    view = -directions
    if light_dir is None:
        light = view  # headlight
    else:
        light = torch.as_tensor(np.asarray(light_dir, np.float32),
                                device=dev).expand(directions.shape)
    n_facing = torch.where((n * view).sum(-1, keepdim=True) < 0, -n, n)
    diffuse = 0.7 * (n_facing * light).sum(-1).abs()
    half_v = (light + view) / torch.clamp_min(_norm(light + view), 1e-9)
    spec = 0.1 * _pow32((n_facing * half_v).sum(-1).abs())
    intensity = (0.2 + diffuse + spec)[..., None]
    color = torch.as_tensor(np.asarray(surface_color, np.float32)[:3],
                            device=dev) * intensity
    bg = torch.as_tensor(np.asarray(background, np.float32), device=dev)
    found_f = found[..., None].to(torch.float32)
    rgb = found_f * color + (1 - found_f) * bg[:3]
    alpha = torch.clamp_min(found.to(torch.float32), bg[3])
    img = torch.cat([rgb, alpha[..., None]], dim=-1)
    if return_depth:
        # Directions are unit vectors, so the ray parameter is the
        # distance.
        return img, torch.where(found, t_surf, math.inf)
    return img


def _refine_and_shade_core(volume, origin, directions, box_min, box_max,
                           iso_value, surface_color, background, lo, hi,
                           found, cap, refine_steps: int = 8,
                           intersection_mode: str = "bisection",
                           closed_surface: bool = False,
                           return_depth: bool = False, light_dir=None,
                           t_start=None):
    """Hit refinement and gradient shading from bracketing intervals.

    ``[lo, hi]`` brackets one sign change of ``f = scalar − iso`` on
    each found ray; the solver pins the crossing, then central
    differences of ±1 voxel in texture space give the normal and
    :func:`shade_surface` shades it. Shared by :func:`iso_composite` and
    the exact marcher's tail (``render/raymarch_exact.py``). ``box_min``
    and ``box_max`` are ``(3,)`` tensors on the rays' device.
    """
    if intersection_mode not in SOLVERS:
        raise ValueError(f"intersection_mode {intersection_mode!r}: one of "
                         f"{SOLVERS}")
    extent = box_max - box_min
    step = hi - lo  # per-ray bracket length

    def f_at(t):
        p = origin + directions * t[..., None]
        return sample_trilinear(volume, (p - box_min) / extent) - iso_value

    def falsi(lo, hi, f_lo, f_hi):
        denom = torch.where((f_hi - f_lo).abs() > 1e-12, f_hi - f_lo, 1.0)
        return lo + torch.clamp(-f_lo / denom, 0.0, 1.0) * (hi - lo)

    if intersection_mode == "analytic":
        # Closed-form cubic root through 4 samples of the segment.
        tau = _smallest_cubic_root01(f_at(lo), f_at(lo + step / 3.0),
                                     f_at(lo + 2.0 * step / 3.0), f_at(hi))
        t_surf = torch.where(torch.isfinite(tau), lo + tau * step,
                             0.5 * (lo + hi))
    elif intersection_mode == "linear":
        # One secant step between the bracketing samples.
        t_surf = falsi(lo, hi, f_at(lo), f_at(hi))
    elif intersection_mode == "marmitt":
        # Regula falsi (Marmitt et al. 2004: repeated linear
        # interpolation within the bracket).
        f_lo, f_hi = f_at(lo), f_at(hi)
        for _ in range(refine_steps):
            mid = falsi(lo, hi, f_lo, f_hi)
            f_mid = f_at(mid)
            same = (f_mid >= 0.0) == (f_lo >= 0.0)
            lo, f_lo = torch.where(same, mid, lo), torch.where(same, f_mid,
                                                                f_lo)
            hi, f_hi = torch.where(same, hi, mid), torch.where(same, f_hi,
                                                                f_mid)
        t_surf = falsi(lo, hi, f_lo, f_hi)
    else:
        # Bisection between t_hit − step and t_hit.
        f_lo = f_at(lo)
        for _ in range(refine_steps):
            mid = 0.5 * (lo + hi)
            f_mid = f_at(mid)
            same = (f_mid >= 0.0) == (f_lo >= 0.0)
            lo = torch.where(same, mid, lo)
            f_lo = torch.where(same, f_mid, f_lo)
            hi = torch.where(same, hi, mid)
        t_surf = 0.5 * (lo + hi)
    if closed_surface and t_start is not None:
        t_surf = torch.where(cap, t_start, t_surf)
    tex = (origin + directions * t_surf[..., None] - box_min) / extent

    # Normal by central differences of one voxel in texture space.
    zs, ys, xs = volume.shape
    eps = np.asarray([1.0, 1.0, 1.0], np.float32) / np.asarray(
        [xs, ys, zs], np.float32)
    comps = []
    for axis in range(3):
        up, down = tex.clone(), tex.clone()
        up[..., axis] += float(eps[axis])
        down[..., axis] -= float(eps[axis])
        comps.append(sample_trilinear(volume, up)
                     - sample_trilinear(volume, down))
    g = torch.stack(comps, dim=-1)
    n = g / torch.clamp_min(_norm(g), 1e-9)

    if closed_surface:
        # Box face normal at the entry point (the reference shader's
        # entryNormal): the slab with the largest entry time is the face
        # the ray came through.
        safe_d = torch.where(directions.abs() > 1e-12, directions, 1e-12)
        t_axis_enter = torch.minimum((box_min - origin) / safe_d,
                                     (box_max - origin) / safe_d)
        axis = torch.argmax(t_axis_enter, dim=-1)
        face_n = -torch.sign(directions) * torch.nn.functional.one_hot(
            axis, 3).to(torch.float32)
        n = torch.where(cap[..., None], face_n, n)

    return shade_surface(n, directions, surface_color, background, found,
                         t_surf, light_dir=light_dir,
                         return_depth=return_depth)


def iso_composite(volume, origin, directions, box_min, box_max,
                  iso_value: float, surface_color, step_size: float,
                  background, num_steps: int, refine_steps: int = 8,
                  light_dir=None, intersection_mode: str = "bisection",
                  closed_surface: bool = False, return_depth: bool = False):
    """The fixed-step marcher: ``(H, W, 4)`` RGBA with the shaded
    isosurface (and, with ``return_depth``, the ``(H, W)`` eye distance
    of each hit, +inf where none: the per-view depth buffer).

    ``volume`` is a ``(Z, Y, X)`` float32 field, ``origin`` ``(3,)`` and
    ``directions`` ``(H, W, 3)`` unit rays on its device; ``box_min``,
    ``box_max``, ``surface_color`` and ``background`` are host values.
    The first sample at the box entry sets the sign; a later sample of
    the other sign inside the box is the hit. ``closed_surface`` caps the
    surface where the box cuts through regions above ``iso_value``: the
    pre-entry value counts as 0 and a crossing at the first step is
    shaded with the box face normal (CLOSE_ISOSURFACES in
    IsoSurfaceRayCasting.glsl:728-770).
    """
    dev = directions.device
    bmin = torch.as_tensor(np.asarray(box_min, np.float32), device=dev)
    bmax = torch.as_tensor(np.asarray(box_max, np.float32), device=dev)
    iso = float(np.float32(iso_value))
    step = np.float32(step_size)
    t_near, t_far, hit = ray_box_intersect(origin, directions, bmin, bmax)
    t_start = torch.clamp_min(t_near, 0.0)
    extent = bmax - bmin

    def f_at(t):
        p = origin + directions * t[..., None]
        return sample_trilinear(volume, (p - bmin) / extent) - iso

    shape = directions.shape[:-1]
    if closed_surface:
        prev_sign = torch.full(shape, -iso >= 0.0, device=dev)
    else:
        prev_sign = f_at(t_start) >= 0.0
    t_hit = torch.full(shape, math.inf, device=dev)
    found = torch.zeros(shape, dtype=torch.bool, device=dev)
    cap = torch.zeros_like(found)
    for i in range(1, num_steps):  # step 0 only sets the entry sign
        t = t_start + float(np.float32(i) * step)
        sign = f_at(t) >= 0.0
        crossing = hit & (t <= t_far) & (sign != prev_sign) & ~found
        t_hit = torch.where(crossing, t, t_hit)
        if closed_surface and i == 1:
            # A crossing against the synthetic pre-entry sign is a
            # boundary cap, not an interior surface.
            cap = crossing
        found = found | crossing
        prev_sign = sign
    lo = torch.where(found, t_hit - float(step), 0.0)
    hi = torch.where(found, t_hit, 1.0)
    return _refine_and_shade_core(
        volume, origin, directions, bmin, bmax, iso, surface_color,
        background, lo, hi, found, cap, refine_steps=refine_steps,
        intersection_mode=intersection_mode, closed_surface=closed_surface,
        return_depth=return_depth, light_dir=light_dir, t_start=t_start)


def iso_render(volume: torch.Tensor, camera, iso_value: float,
               surface_color=(0.9, 0.4, 0.2, 1.0), image_size=(512, 512),
               box=None, voxel_step: float = 0.25,
               background=(0.0, 0.0, 0.0, 1.0), refine_steps: int = 8,
               intersection_mode: str = "bisection", model_matrix=None,
               closed_surface: bool = False, return_depth: bool = False):
    """Render an isosurface of a ``(Z, Y, X)`` float32 field with the
    fixed-step marcher (:func:`iso_composite`) on the field's device.

    ``image_size`` is ``(width, height)``; ``box`` defaults to the
    normalized ±0.25 box of the volume dims; the step is ``voxel_step``
    times the smallest voxel extent. ``model_matrix`` is the volume's
    4×4 model transform: rays are pulled into model space with its
    inverse, as in ``dvr_render``. Returns ``(H, W, 4)`` straight-alpha
    RGBA and, with ``return_depth``, the ``(H, W)`` hit distances.
    """
    zs, ys, xs = volume.shape
    if box is None:
        box = default_render_box((zs, ys, xs))
    box_min = np.asarray(box[0], np.float32)
    box_max = np.asarray(box[1], np.float32)
    step = world_step_size(volume.shape, box_min, box_max, voxel_step)
    width, height = image_size
    origin, directions = camera.rays(width, height, device=volume.device)
    if model_matrix is not None:
        origin, directions = to_model_space(origin, directions,
                                            *model_inverse(model_matrix))
    return iso_composite(
        volume, origin, directions, box_min, box_max, iso_value,
        surface_color, step, background, num_steps_for(box_min, box_max,
                                                       step),
        refine_steps, intersection_mode=intersection_mode,
        closed_surface=bool(closed_surface), return_depth=bool(return_depth))
