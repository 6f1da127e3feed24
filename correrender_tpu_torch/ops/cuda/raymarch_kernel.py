"""B5 (exact plane-order DVR) and B6 (the isosurface's first hit), both
in ``csrc/raymarch.cu``, beside their plain PyTorch versions, and the
host-side plan that defines their samples.

Counterpart of ``correrender_tpu/ops/pallas/raymarch_kernel.py``. Rays from one camera share the sign of their direction along the
volume's principal axis, so marching a *plane index* front to back
visits every ray's samples in compositing order. For a ray the sample on
slab k, sub-step s sits at march distance ``γ(k, s) = g0 + (k − 1)·gk +
s·gs`` along the axis, and its in-plane voxel coordinates are affine in
γ with per-ray slopes: ``u = u0c + γ·su``, ``v = v0c + γ·sv``. The host
computes the camera constants (:func:`_common_params`, float64 then
float32). B5's per-ray fields ``su, sv, inv_da, t0, t1`` come from
:func:`_ray_fields` (PyTorch on the volume's device), and B5 and its
plain version march from the same inputs. B6 sets up its rays itself,
from the host constants of :func:`_iso_ray_constants`, in the order of
single float32 operations of :func:`iso_ray_fields`, which its plain
version calls: the two agree bit for bit.

Departures from the TPU kernel, by design:

* The exit is per ray once alpha reaches 0.999 (the reference shader's
  rule), where the TPU stopped a whole 8×128 subtile; the two differ only
  on saturated rays, by at most 1e-3.
* There are no brick buckets: a per-ray kernel has no VMEM limit, so
  extreme zoom-outs render here instead of falling back to
  ``render/dvr.py``.
* A camera whose rays do not all advance along the principal axis
  (``d_a·sgn ≤ 0`` at an image corner) raises :class:`RaymarchUnsupported`;
  the TPU planner tested only ``d_a == 0`` and rendered such rays as
  background.
* A transfer function without control points raises
  :class:`RaymarchUnsupported` instead of marching a gray ramp.
* B5 evaluates the transfer function in segment form (:func:`tf_segments`:
  a binary search for the segment, then 4 FMAs), where the TPU kernel
  and B5's plain version sum its hinges (:func:`tf_hinges`); the two are
  the same piecewise-linear function and differ by rounding only
  (``tests/test_torch_port_exact.py::test_tf_segments_match_the_hinge_sum``).
* B6 takes ``refine_steps`` but neither ``ns`` (subtiles per grid step)
  nor ``interpret``: both belong to the TPU kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.render.camera import (
    default_render_box,
    ray_dirs_affine,
)
from correrender_tpu_torch.render.dvr import model_inverse, to_model_space
from correrender_tpu_torch.render.sampling import ray_box_intersect

_NAN_SENTINEL = 1e30
_NAN_THRESH = 1e20
_EXIT_ALPHA = 0.999
_MAX_KNOTS = 24  # kMaxKnots in csrc/raymarch.cu

#: world axis index → (Z, Y, X) array axis index
_WORLD_TO_ARR = {0: 2, 1: 1, 2: 0}
_NAN_MODES = {"ignore": 0, "yellow": 1}
_METRICS = {None: 0, "euclidean": 1, "chebyshev": 2}


class RaymarchUnsupported(Exception):
    """Raised by the host plan when a frame cannot ride the marcher;
    ``render/raymarch_exact.py`` then renders it with ``render/dvr.py``."""


def _forward(camera) -> np.ndarray:
    f = (np.asarray(camera.look_at_point, np.float64)
         - np.asarray(camera.position, np.float64))
    return f / np.linalg.norm(f)


def prepare_raymarch_volume(volume: torch.Tensor, axis_world: int,
                            flip: bool, lane_axis_world: int) -> torch.Tensor:
    """The marcher's layout of a ``(Z, Y, X)`` field: ``(A, S, L)``
    float32, contiguous, on the field's device. A = planes along the
    principal world axis (reversed when ``flip``, so plane order is front
    to back), L = the in-plane lane axis, S = the other one. NaN becomes
    a 1e30 sentinel: a sample whose support touches it (with a nonzero
    weight) exceeds 1e20 and is treated per ``nan_mode``. No padding: the
    kernel clamps its taps to the edge."""
    arr_a = _WORLD_TO_ARR[axis_world]
    arr_l = _WORLD_TO_ARR[lane_axis_world]
    arr_s = ({0, 1, 2} - {arr_a, arr_l}).pop()
    vol = volume.to(torch.float32).permute(arr_a, arr_s, arr_l)
    if flip:
        vol = vol.flip(0)
    return torch.where(torch.isnan(vol), _NAN_SENTINEL, vol).contiguous()


def _tf_knots(tf):
    """The merged knots of a transfer function's colour and opacity
    control points, the four channels' values there and the slopes of
    the segments between them, in float64: ``(knots (K,), vals (4, K),
    seg (4, K))``, ``seg[:, K − 1] = 0`` (flat after the last knot, the
    LUT's clamp). Raises :class:`RaymarchUnsupported` as
    :func:`tf_hinges` documents."""
    color, opacity = tf.color_points, tf.opacity_points
    if not color or not opacity:
        raise RaymarchUnsupported(
            "transfer function has no control points (LUT only)")
    knots = sorted({0.0} | {float(x) for x, _ in color}
                   | {float(x) for x, _ in opacity})
    if len(knots) > _MAX_KNOTS:
        raise RaymarchUnsupported(f"{len(knots)} TF knots > {_MAX_KNOTS}")

    def interp(points, u):
        xs = [float(p[0]) for p in points]
        vs = [np.atleast_1d(np.asarray(p[1], np.float64)) for p in points]
        if u <= xs[0]:
            return vs[0]
        if u >= xs[-1]:
            return vs[-1]
        i = min(int(np.searchsorted(xs, u, side="right")) - 1, len(xs) - 2)
        span = xs[i + 1] - xs[i]
        w = 0.0 if span <= 0 else (u - xs[i]) / span
        return vs[i] * (1 - w) + vs[i + 1] * w

    ks = np.asarray(knots, np.float64)
    vals = np.stack([np.concatenate([interp(color, u), interp(opacity, u)])
                     for u in ks], axis=1)  # (4, K)
    seg = np.zeros((4, len(knots)), np.float64)
    for i in range(len(knots) - 1):
        span = ks[i + 1] - ks[i]
        seg[:, i] = 0.0 if span <= 0 else (vals[:, i + 1] - vals[:, i]) / span
    return ks, vals, seg


def tf_hinges(tf):
    """Hinge decomposition of a piecewise-linear transfer function.

    ``value_ch(u) = base_ch + Σᵢ slope_ch,i · relu(u − knot_i)`` over the
    merged knots of the colour and opacity control points: exactly the
    control-point function the reference's LUT samples. Returns
    ``(knots (K,), slopes (4, K), base (4,))`` float32 numpy. The JAX
    package pads K to a multiple of 4 with inert knots at 2.0; the port
    does not pad. B5's plain version sums these hinges.

    Raises :class:`RaymarchUnsupported` for more than 24 knots (the
    kernel's parameter block) and for a transfer function without control
    points (the JAX package
    marches a gray ramp there instead).
    """
    ks, vals, seg = _tf_knots(tf)
    # Hinge i = the slope change at knot i (flat before the first).
    hinge = seg.copy()
    hinge[:, 1:] = seg[:, 1:] - seg[:, :-1]
    return (ks.astype(np.float32), hinge.astype(np.float32),
            vals[:, 0].astype(np.float32))


def tf_segments(tf):
    """Segment form of the same transfer function, as kernel B5 evaluates
    it: ``value_ch(u) = values[ch, i] + slopes[ch, i] · (u − knots[i])``
    for the last knot ``i`` with ``knots[i] ≤ u``. Returns ``(knots (K,),
    values (4, K), slopes (4, K))`` float32 numpy, each rounded once from
    the float64 values :func:`tf_hinges` builds; the slope after the last
    knot is 0. The function is the hinge sum's; the two differ only by
    rounding. Raises as :func:`tf_hinges`."""
    ks, vals, seg = _tf_knots(tf)
    return (ks.astype(np.float32), vals.astype(np.float32),
            seg.astype(np.float32))


def _lane_axis(e0, ex, ey, width, height, a, in_plane, flip, voxel,
               o_a, box_min, box_max):
    """The in-plane lane axis as the JAX planner picks it: the candidate
    with the smaller worst-case footprint of an 8×128-pixel tile across
    the box. The two candidates' costs agree up to rounding, so this
    mostly returns ``in_plane[0]``; it is kept so that both packages lay
    the volume out alike. The per-ray kernel needs no brick size."""
    tile_h, tile_w = 8, 128
    hp = -(-height // tile_h) * tile_h
    wp = -(-width // tile_w) * tile_w
    gy = np.minimum(np.arange(0, hp + 1, tile_h, np.float64), float(height))
    gx = np.minimum(np.arange(0, wp + 1, tile_w, np.float64), float(width))
    d = e0 + ex * gx[None, :, None] + ey * gy[:, None, None]
    sgn = -1.0 if flip else 1.0
    g_ends = np.asarray([box_min[a] - o_a, box_max[a] - o_a]) * sgn
    g_lo, g_hi = float(g_ends.min()), float(g_ends.max())
    ga = abs(voxel[a])

    def worst(slope):
        corners = np.stack([slope[:-1, :-1], slope[:-1, 1:], slope[1:, :-1],
                            slope[1:, 1:]])
        span = corners.max(axis=0) - corners.min(axis=0)
        return max(max(np.max(abs(g) * span) for g in
                       (g_lo - ga, g_hi - ga, g_lo + ga, g_hi + ga)), 0.0)

    best = None
    for lane in in_plane:
        sub = in_plane[0] if lane == in_plane[1] else in_plane[1]
        su = (d[..., sub] / d[..., a]) * sgn / voxel[sub]
        sv = (d[..., lane] / d[..., a]) * sgn / voxel[lane]
        cost = (worst(su) + 5 + 8) + (worst(sv) + 5 + 1)
        if best is None or cost < best[0]:
            best = (cost, lane, sub)
    return best[1], best[2]


def plan_raymarch(camera, volume_shape, image_size, box=None, q=4,
                  model_matrix=None) -> dict:
    """Static plan of a frame: principal axis, slice order, in-plane
    axes, voxel geometry, the model transform's inverse and ``q``.

    Raises :class:`RaymarchUnsupported` when a ray does not advance along
    the principal axis (``d_a·sgn ≤ 0`` at an image corner; the ray
    direction is affine in the pixel coordinates, so the corners bound
    it).
    """
    zs, ys, xs = volume_shape
    if box is None:
        box = default_render_box(volume_shape)
    box_min = np.asarray(box[0], np.float64)
    box_max = np.asarray(box[1], np.float64)
    dims_world = {0: xs, 1: ys, 2: zs}
    voxel = (box_max - box_min) / np.asarray([xs, ys, zs], np.float64)
    # The plan, the per-ray fields and the march live in model space.
    if model_matrix is not None:
        m_rot, m_trans = model_inverse(model_matrix, np.float64)
    else:
        m_rot, m_trans = np.eye(3), np.zeros(3)
    forward = m_rot @ _forward(camera)
    forward = forward / np.linalg.norm(forward)
    a = int(np.argmax(np.abs(forward)))
    flip = bool(forward[a] < 0)
    in_plane = [w for w in range(3) if w != a]
    width, height = image_size

    e0, ex, ey = (m_rot @ np.asarray(v, np.float64)
                  for v in ray_dirs_affine(camera, width, height))
    sgn = -1.0 if flip else 1.0
    for px, py in ((0, 0), (width - 1, 0), (0, height - 1),
                   (width - 1, height - 1)):
        if (e0[a] + ex[a] * px + ey[a] * py) * sgn <= 0.0:
            raise RaymarchUnsupported(
                "rays straddle the principal-axis pole (mixed-sign d_a)")
    o_model = m_rot @ np.asarray(camera.position, np.float64) + m_trans
    lane, sub = _lane_axis(e0, ex, ey, width, height, a, in_plane, flip,
                           voxel, float(o_model[a]), box_min, box_max)
    return {
        "axis_world": a, "flip": flip, "lane_axis": lane, "sub_axis": sub,
        "q": int(q), "box_min": box_min, "box_max": box_max, "voxel": voxel,
        "planes": dims_world[a], "sub_extent": dims_world[sub],
        "lane_extent": dims_world[lane], "m_rot": m_rot, "m_trans": m_trans,
    }


def _common_params(plan, camera, q):
    """γ decomposition and the camera-constant in-plane base coordinates.

    γ is the world distance travelled along the (flip-corrected)
    principal axis: ``t = γ · inv_da``, ``inv_da = 1/(d_a·sgn)``. Plane
    i's voxel centre sits at ``g0_plane + i·ga``; slab k's sub-step s at
    ``g0 + (k − 1)·ga + s·ga/q`` with ``g0 = g0_plane + 0.5·ga/q``.
    Returns ``(g0, ga, ga/q, u0c, v0c, g0_plane)`` as float64.
    """
    a = plan["axis_world"]
    voxel = plan["voxel"]
    o = plan["m_rot"] @ np.asarray(camera.position, np.float64) + plan[
        "m_trans"]
    box_min, box_max = plan["box_min"], plan["box_max"]
    ga = float(abs(voxel[a]))
    if plan["flip"]:
        g0_plane = float(o[a]) - (float(box_max[a]) - 0.5 * ga)
    else:
        g0_plane = (float(box_min[a]) + 0.5 * ga) - float(o[a])
    sub, lane = plan["sub_axis"], plan["lane_axis"]
    u0c = (o[sub] - box_min[sub]) / voxel[sub] - 0.5
    v0c = (o[lane] - box_min[lane]) / voxel[lane] - 0.5
    return (g0_plane + 0.5 * ga / q, ga, ga / q, float(u0c), float(v0c),
            float(g0_plane))


def _ray_fields(camera, image_size, plan, device,
                depth_limit=None) -> torch.Tensor:
    """``(5, H, W)`` float32 per-ray fields ``su, sv, inv_da, t0, t1``.

    ``t0, t1`` bound the march (the slab test, started at the eye when it
    is inside; a ray that misses gets ``t1 = t0 − 1``), and ``t1`` is cut
    at ``depth_limit`` (world eye distances) where one is given.
    """
    width, height = image_size
    origin, dirs = camera.rays(width, height, device=device)
    origin, dirs = to_model_space(origin, dirs, plan["m_rot"],
                                  plan["m_trans"])
    box_min = torch.as_tensor(plan["box_min"].astype(np.float32),
                              device=device)
    box_max = torch.as_tensor(plan["box_max"].astype(np.float32),
                              device=device)
    t_near, t_far, hit = ray_box_intersect(origin, dirs, box_min, box_max)
    t0 = torch.clamp_min(t_near, 0.0)
    t1 = torch.where(hit, t_far, t0 - 1.0)
    if depth_limit is not None:
        t1 = torch.minimum(t1, torch.as_tensor(
            depth_limit, dtype=torch.float32, device=device).reshape(
                height, width))
    a = plan["axis_world"]
    voxel = plan["voxel"].astype(np.float32)
    inv_da = 1.0 / (dirs[..., a] * (-1.0 if plan["flip"] else 1.0))
    su = dirs[..., plan["sub_axis"]] * inv_da / float(voxel[plan["sub_axis"]])
    sv = dirs[..., plan["lane_axis"]] * inv_da / float(
        voxel[plan["lane_axis"]])
    return torch.stack([su, sv, inv_da, t0, t1])


def _march_params(plan, camera, tf, attenuation, restriction):
    """Host scalars of the march: ``(params (18,), tfp (5, 1 + K),
    metric)`` float32; the layout of ``params`` is RayParams.p in
    ``csrc/raymarch.cu``."""
    q = plan["q"]
    knots, slopes, base = tf_hinges(tf)
    g0, gk, gs, u0c, v0c, _ = _common_params(plan, camera, q)
    vmin, vmax = float(tf.domain[0]), float(tf.domain[1])
    metric = None
    rest_vals = [0.0] * 6
    if restriction is not None:
        center, radius, name = restriction
        metric = "chebyshev" if str(name).lower() == "chebyshev" else (
            "euclidean")
        c = np.asarray(center, np.float64)
        o = plan["m_rot"] @ np.asarray(camera.position, np.float64) + plan[
            "m_trans"]
        a, sub, lane = plan["axis_world"], plan["sub_axis"], plan["lane_axis"]
        vox = plan["voxel"]
        # γ of the centre's plane; in-plane centre in voxel coordinates
        # (the frame of the per-ray raw_u / raw_v).
        rest_vals = [
            float((c[a] - o[a]) * (-1.0 if plan["flip"] else 1.0)),
            float((c[sub] - plan["box_min"][sub]) / vox[sub] - 0.5),
            float((c[lane] - plan["box_min"][lane]) / vox[lane] - 0.5),
            float(radius), float(abs(vox[sub])), float(abs(vox[lane])),
        ]
    params = np.asarray([
        g0, gk, gs, plan["sub_extent"] - 1, plan["lane_extent"] - 1,
        u0c, v0c, float(attenuation), vmin, 1.0 / max(vmax - vmin, 1e-30),
        abs(float(plan["voxel"][plan["axis_world"]])) / q, 1.0 / q,
        *rest_vals,
    ], np.float32)
    tfp = np.zeros((5, 1 + len(knots)), np.float32)
    tfp[0, 1:] = knots
    tfp[1:, 0] = base
    tfp[1:, 1:] = slopes
    return params, tfp, metric


def _check_prepared(vol_prepared, plan):
    if tuple(vol_prepared.shape) != (plan["planes"], plan["sub_extent"],
                                     plan["lane_extent"]):
        raise ValueError(f"prepared volume {tuple(vol_prepared.shape)} does "
                         "not match the plan")


def _inputs(vol_prepared, camera, tf, image_size, plan, attenuation,
            nan_mode, depth_limit, restriction):
    if nan_mode not in _NAN_MODES:
        raise ValueError(f"nan_mode {nan_mode!r}: the marcher takes "
                         f"{sorted(_NAN_MODES)}")
    _check_prepared(vol_prepared, plan)
    params, tfp, metric = _march_params(plan, camera, tf, attenuation,
                                        restriction)
    fields = _ray_fields(camera, image_size, plan, vol_prepared.device,
                         depth_limit)
    return fields, params, tfp, metric


def _sample_slab(flat, lo_off, hi_off, wz, raw_u, raw_v, u_max, v_max,
                 n_sub, n_lane):
    """The plain versions' sample: the z-lerp by ``wz`` between the planes
    at element offsets ``lo_off`` and ``hi_off`` of the flat ``(A·S·L,)``
    volume, of the bilinear sample at ``(clamp(raw_u), clamp(raw_v))``.
    Every product and sum is one float32 operation, as ``sample_slab`` in
    ``csrc/raymarch.cu`` rounds it."""
    uc = torch.clamp(raw_u, 0.0, float(u_max))
    vc = torch.clamp(raw_v, 0.0, float(v_max))
    iu = torch.clamp(uc.to(torch.long), max=n_sub - 1)
    iv = torch.clamp(vc.to(torch.long), max=n_lane - 1)
    fu = uc - iu
    fv = vc - iv
    iu1 = torch.clamp(iu + 1, max=n_sub - 1)
    iv1 = torch.clamp(iv + 1, max=n_lane - 1)

    def tap(i, j):
        idx = i * n_lane + j
        return (1.0 - wz) * flat[lo_off + idx] + wz * flat[hi_off + idx]

    return ((1.0 - fu) * ((1.0 - fv) * tap(iu, iv) + fv * tap(iu, iv1))
            + fu * ((1.0 - fv) * tap(iu1, iv) + fv * tap(iu1, iv1)))


def dvr_raymarch_plain(vol_prepared, camera, tf, image_size, plan,
                       attenuation=100.0, nan_mode="ignore",
                       depth_limit=None, restriction=None, samples=None):
    """Plain version of B5: the same march as a plane-order loop over
    all rays at once, with the per-ray exit as a mask. Returns
    premultiplied ``(rgb (H, W, 3), a (H, W))``. A list passed as
    ``samples`` receives the number of samples the rays took (for a
    kernel's bound: the work these inputs need).

    The scalars that decide whether a sample counts (γ, and the ball's
    axial distance) are float32 host values, and the per-ray tests are
    single float32 tensor operations, so they round as the kernel's do.
    """
    fields, params, tfp, metric = _inputs(
        vol_prepared, camera, tf, image_size, plan, attenuation, nan_mode,
        depth_limit, restriction)
    f32 = np.float32
    (g0, gk, gs, u_max, v_max, u0c, v0c, atten, vmin, inv_vspan, dt_unit,
     inv_q, r_gc, r_cs, r_cl, r_rad, vox_s, vox_l) = (f32(v) for v in params)
    su, sv, inv_da, t0, t1 = fields
    planes, n_sub, n_lane = vol_prepared.shape
    flat = vol_prepared.reshape(-1)
    plane = n_sub * n_lane
    dt = float(dt_unit) * inv_da.abs()
    k = tfp.shape[1] - 1
    rgb = torch.zeros(inv_da.shape + (3,), dtype=torch.float32,
                      device=inv_da.device)
    acc_a = torch.zeros_like(inv_da)
    taken = torch.zeros((), dtype=torch.int64, device=inv_da.device)
    for kk in range(planes + 1):
        lo_off = max(kk - 1, 0) * plane
        hi_off = min(kk, planes - 1) * plane
        gbase = g0 + f32(kk - 1) * gk
        for s in range(plan["q"]):
            gamma = gbase + f32(s) * gs
            wz = (f32(s) + f32(0.5)) * inv_q
            t = inv_da * float(gamma)
            active = (t >= t0) & (t <= t1) & (acc_a < _EXIT_ALPHA)
            raw_u = su * float(gamma) + float(u0c)
            raw_v = sv * float(gamma) + float(v0c)
            if metric is not None:
                d_a = abs(gamma - r_gc)
                d_s = (raw_u - float(r_cs)).abs() * float(vox_s)
                d_l = (raw_v - float(r_cl)).abs() * float(vox_l)
                if metric == "chebyshev":
                    inside = torch.clamp_min(torch.maximum(d_s, d_l),
                                             float(d_a)) <= float(r_rad)
                else:
                    inside = (float(d_a * d_a) + d_s * d_s) + d_l * d_l <= (
                        float(r_rad * r_rad))
                active = active & inside
            if samples is not None:
                taken += active.sum()
            val = _sample_slab(flat, lo_off, hi_off, float(wz), raw_u, raw_v,
                               u_max, v_max, n_sub, n_lane)
            u = torch.clamp((val - float(vmin)) * float(inv_vspan), 0.0, 1.0)
            c = [torch.full_like(u, float(tfp[1 + ch, 0])) for ch in range(4)]
            for i in range(k):
                h = torch.clamp_min(u - float(tfp[0, 1 + i]), 0.0)
                c = [c[ch] + float(tfp[1 + ch, 1 + i]) * h for ch in range(4)]
            is_nan = val > _NAN_THRESH
            if nan_mode == "yellow":
                c = [torch.where(is_nan, v, c[ch])
                     for ch, v in enumerate((1.0, 1.0, 0.0, 1.0))]
            else:
                c[3] = torch.where(is_nan, 0.0, c[3])
            alpha = torch.where(
                active, 1.0 - torch.exp(-c[3] * dt * float(atten)), 0.0)
            w = (1.0 - acc_a) * alpha
            rgb = rgb + w[..., None] * torch.stack(c[:3], dim=-1)
            acc_a = acc_a + w
    if samples is not None:
        samples.append(int(taken))
    return rgb, acc_a


def dvr_raymarch(vol_prepared, camera, tf, image_size, plan,
                 attenuation=100.0, nan_mode="ignore", depth_limit=None,
                 restriction=None):
    """Exact DVR of a prepared volume (:func:`prepare_raymarch_volume`).

    Args:
      vol_prepared: ``(A, S, L)`` float32 layout for ``plan``.
      camera, tf: the view and a transfer function with control points.
      image_size: ``(width, height)``.
      plan: :func:`plan_raymarch` result with its ``q``.
      nan_mode: "ignore" or "yellow".
      depth_limit: optional ``(H, W)`` world eye distances; samples beyond
        them are skipped (the shared per-view depth buffer).
      restriction: optional ``(center_xyz, radius, metric)``: samples
        outside the ball (world metric, "Euclidean" or "Chebyshev") are
        skipped (RenderRestriction.glsl).

    Returns:
      Premultiplied ``(rgb (H, W, 3), a (H, W))`` float32. A CPU volume
      takes :func:`dvr_raymarch_plain`; a CUDA volume launches B5.
    """
    args = (vol_prepared, camera, tf, image_size, plan, attenuation,
            nan_mode, depth_limit, restriction)
    dev = vol_prepared.device
    if dev.type == "cpu":
        return dvr_raymarch_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"no raymarch kernel for device {dev}")
    _build.require_cuda_tensor(vol_prepared, "vol_prepared", torch.float32,
                               dev)
    fields, params, _, metric = _inputs(*args)
    fields = fields.contiguous()
    knots, values, slopes = tf_segments(tf)
    table = np.ascontiguousarray(
        np.concatenate([knots[None], values, slopes]))  # (9, K)
    width, height = image_size
    rgb = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty((height, width), dtype=torch.float32, device=dev)
    if alpha.numel() == 0:
        return rgb, alpha
    planes, sub, lane = vol_prepared.shape
    lib = _build.library()
    _build.LAUNCHES["raymarch_dvr"] += 1
    err = lib.correrender_raymarch_dvr(
        vol_prepared.data_ptr(), planes, sub, lane, fields.data_ptr(),
        width, height, params.ctypes.data, table.ctypes.data,
        len(knots), plan["q"], _NAN_MODES[nan_mode], _METRICS[metric],
        rgb.data_ptr(), alpha.data_ptr(), dev.index, _build.stream_of(alpha),
    )
    _build.check(err, "raymarch_dvr")
    return rgb, alpha


def model_eye(plan, camera, inv_view=None) -> np.ndarray:
    """The eye in model space, ``m_rot·o + m_trans`` in single float32
    operations: the origin of the rays whose directions
    :func:`iso_raymarch` returns. ``inv_view``: the camera's inverse view
    matrix, where the caller has it."""
    if inv_view is None:
        inv_view = camera.inverse_view_matrix()
    rot = np.asarray(plan["m_rot"], np.float32)
    eye = inv_view[:3, 3]
    return ((rot[:, 0] * eye[0] + rot[:, 1] * eye[1]) + rot[:, 2] * eye[2]
            + np.asarray(plan["m_trans"], np.float32))


def _iso_ray_constants(plan, camera, image_size) -> dict:
    """Host constants of B6's ray setup, float32: the inverse
    projection's first three rows, the inverse view's rotation, the model
    inverse's rotation with its rows in (principal, sub, lane) order, the
    box's corners less the eye (:func:`model_eye`) in that axis order,
    the sign of the slice order and the sub and lane voxel extents."""
    width, height = image_size
    order = [plan["axis_world"], plan["sub_axis"], plan["lane_axis"]]
    inv_view = camera.inverse_view_matrix()
    eye = model_eye(plan, camera, inv_view)
    voxel = plan["voxel"].astype(np.float32)
    return {
        "inv_proj": camera.inverse_projection_matrix(width / height)[:3],
        "inv_view": inv_view[:3, :3],
        "rot": np.asarray(plan["m_rot"], np.float32)[order],
        "lo": (plan["box_min"].astype(np.float32) - eye)[order],
        "hi": (plan["box_max"].astype(np.float32) - eye)[order],
        "sgn": np.float32(-1.0 if plan["flip"] else 1.0),
        "vox_s": voxel[plan["sub_axis"]], "vox_l": voxel[plan["lane_axis"]],
        "order": order,
    }


def iso_ray_fields(camera, image_size, plan, device):
    """B6's per-ray fields ``(su, sv, inv_da, t0, t1)``, each ``(H, W)``,
    and the unit model-space ray directions ``(H, W, 3)``, in the order
    of single float32 operations that B6's ray setup (``iso_ray_setup``
    in ``csrc/raymarch.cu``) follows: the NDC pixel centre through the
    inverse projection (NDC z = 1), normalised by the square root of a
    sum of squares, then through the inverse view's rotation and the
    model inverse's as explicit sums of products; the slab test with
    NaN-propagating minima and maxima; ``t0 = max(t_near, 0)``, ``t1 =
    t_far`` where the ray meets the box in front of the eye, else ``t0 −
    1``; ``inv_da = 1/(sgn·d_a)``, ``su = d_s·inv_da/voxel_s``, ``sv =
    d_l·inv_da/voxel_l``. Every division divides by a tensor (PyTorch on
    a GPU multiplies by the reciprocal of a Python number). The fields
    are those of :func:`_ray_fields` up to rounding."""
    c = _iso_ray_constants(plan, camera, image_size)
    width, height = image_size
    f32 = np.float32

    def centres(count):  # the pixel centres in [0, 1]
        return (np.arange(count, dtype=f32) + f32(0.5)) / f32(count)

    gx = torch.as_tensor(centres(width) * f32(2.0) - f32(1.0),
                         device=device).reshape(1, width)
    gy = torch.as_tensor(f32(1.0) - centres(height) * f32(2.0),
                         device=device).reshape(height, 1)
    p = c["inv_proj"]
    vt = [((gx * float(p[i, 0]) + gy * float(p[i, 1])) + float(p[i, 2]))
          + float(p[i, 3]) for i in range(3)]
    nrm = torch.sqrt((vt[0] * vt[0] + vt[1] * vt[1]) + vt[2] * vt[2])
    vd = [v / nrm for v in vt]

    def rotate(m, v):
        return [(v[0] * float(m[i, 0]) + v[1] * float(m[i, 1]))
                + v[2] * float(m[i, 2]) for i in range(3)]

    d = rotate(c["rot"], rotate(c["inv_view"], vd))  # (principal, sub, lane)
    t_near = t_far = None
    for i in range(3):
        inv = torch.reciprocal(d[i])
        ta, tb = inv * float(c["lo"][i]), inv * float(c["hi"][i])
        lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
        t_near = lo if t_near is None else torch.maximum(t_near, lo)
        t_far = hi if t_far is None else torch.minimum(t_far, hi)
    t0 = torch.clamp_min(t_near, 0.0)
    t1 = torch.where((t_near <= t_far) & (t_far >= 0.0), t_far, t0 - 1.0)
    inv_da = torch.reciprocal(d[0] * float(c["sgn"]))

    def t32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    su = (d[1] * inv_da) / t32(c["vox_s"])
    sv = (d[2] * inv_da) / t32(c["vox_l"])
    directions = [None] * 3
    for i, ch in enumerate(c["order"]):
        directions[ch] = d[i]
    return su, sv, inv_da, t0, t1, torch.stack(directions, dim=-1)


def _iso_params(plan, camera, iso_value, image_size):
    """Host scalars of the iso march and its ray setup, float32: the
    layout of ``IsoParams.p`` then ``IsoParams.r`` in
    ``csrc/raymarch.cu``."""
    q = plan["q"]
    g0, gk, gs, u0c, v0c, g0p = _common_params(plan, camera, q)
    c = _iso_ray_constants(plan, camera, image_size)
    return np.concatenate([np.asarray([
        g0, gk, gs, plan["sub_extent"] - 1, plan["lane_extent"] - 1, u0c,
        v0c, float(iso_value), g0p, 1.0 / gk, 1.0 / q,
    ], np.float32), c["inv_proj"].reshape(-1), c["inv_view"].reshape(-1),
        c["rot"].reshape(-1), c["lo"], c["hi"],
        np.asarray([c["sgn"], c["vox_s"], c["vox_l"]], np.float32)])


def iso_raymarch_plain(vol_prepared, camera, iso_value, image_size, plan,
                       refine_steps: int = 8, samples=None):
    """Plain version of B6: the ray fields (:func:`iso_ray_fields`), then
    the march as a plane-order loop over all rays at once (a found ray
    stops as a mask), then the bisection and the gradients for every ray,
    kept where a ray found its crossing. Returns :func:`iso_raymarch`'s
    six tensors. A list passed as ``samples`` receives the number of
    trilinear samples the rays took: the march's samples up to each
    crossing, and ``refine_steps + 6`` for each found ray's refinement.

    The positions and sample values that decide a crossing are single
    float32 tensor operations, so they round as the kernel's do.
    """
    _check_prepared(vol_prepared, plan)
    params = _iso_params(plan, camera, iso_value, image_size)
    (g0, gk, gs, u_max, v_max, u0c, v0c, iso, g0p, inv_ga, inv_q) = (
        np.float32(v) for v in params[:11])
    su, sv, inv_da, t0, t1, directions = iso_ray_fields(
        camera, image_size, plan, vol_prepared.device)
    planes, n_sub, n_lane = vol_prepared.shape
    flat = vol_prepared.reshape(-1)
    plane = n_sub * n_lane
    f32 = np.float32
    found = torch.zeros_like(inv_da, dtype=torch.bool)
    have_prev = torch.zeros_like(found)
    zero = torch.zeros_like(inv_da)
    t_hit, f_lo, f_hi, prev = zero, zero, zero, zero
    taken = torch.zeros((), dtype=torch.int64, device=inv_da.device)
    for kk in range(planes + 1):
        lo_off = max(kk - 1, 0) * plane
        hi_off = min(kk, planes - 1) * plane
        gbase = g0 + f32(kk - 1) * gk
        for s in range(plan["q"]):
            gamma = gbase + f32(s) * gs
            wz = (f32(s) + f32(0.5)) * inv_q
            t = inv_da * float(gamma)
            live = (t >= t0) & (t <= t1) & ~found
            if samples is not None:
                taken += live.sum()
            val = _sample_slab(flat, lo_off, hi_off, float(wz),
                               su * float(gamma) + float(u0c),
                               sv * float(gamma) + float(v0c), u_max, v_max,
                               n_sub, n_lane)
            active = live & (val < _NAN_THRESH)
            f = val - float(iso)
            crossing = active & have_prev & ((f >= 0.0) != (prev >= 0.0))
            t_hit = torch.where(crossing, t, t_hit)
            f_lo = torch.where(crossing, prev, f_lo)
            f_hi = torch.where(crossing, f, f_hi)
            found = found | crossing
            prev = torch.where(active, f, prev)
            have_prev = have_prev | active
    if samples is not None:
        samples.append(int(taken) + int(found.sum()) * (
            refine_steps + 6 if refine_steps > 0 else 0))
    if refine_steps <= 0:
        return found, t_hit, f_lo, f_hi, zero, directions

    def sample_ray(gamma, du=0.0, dv=0.0, dz=0.0):
        zc = torch.clamp((gamma - float(g0p)) * float(inv_ga) + dz, 0.0,
                         float(planes - 1))
        iz = torch.clamp(zc.to(torch.long), max=planes - 1)
        iz1 = torch.clamp(iz + 1, max=planes - 1)
        return _sample_slab(flat, iz * plane, iz1 * plane, zc - iz,
                            (su * gamma + float(u0c)) + du,
                            (sv * gamma + float(v0c)) + dv, u_max, v_max,
                            n_sub, n_lane)

    # Bisection in γ over [γ_hit − gs, γ_hit], γ_hit = t_hit·da as the TPU
    # kernel recovers it; then ±1-voxel central differences.
    g_hi = t_hit * (1.0 / inv_da)
    g_lo = g_hi - float(gs)
    fl = f_lo
    for _ in range(refine_steps):
        gm = 0.5 * (g_lo + g_hi)
        fm = sample_ray(gm) - float(iso)
        same = (fm >= 0.0) == (fl >= 0.0)
        g_lo = torch.where(same, gm, g_lo)
        fl = torch.where(same, fm, fl)
        g_hi = torch.where(same, g_hi, gm)
    g = 0.5 * (g_lo + g_hi)
    outs = (g * inv_da,
            sample_ray(g, dz=1.0) - sample_ray(g, dz=-1.0),
            sample_ray(g, du=1.0) - sample_ray(g, du=-1.0),
            sample_ray(g, dv=1.0) - sample_ray(g, dv=-1.0))
    return (found,) + tuple(torch.where(found, o, 0.0) for o in outs) + (
        directions,)


def iso_raymarch(vol_prepared, camera, iso_value, image_size, plan,
                 refine_steps: int = 8):
    """First crossing of ``iso_value`` along each pixel ray of a prepared
    volume (:func:`prepare_raymarch_volume`).

    Args:
      vol_prepared: ``(A, S, L)`` float32 layout for ``plan``.
      camera, image_size: the view and ``(width, height)``.
      plan: :func:`plan_raymarch` result with its ``q``.
      refine_steps: bisection steps of the crossing in the kernel.

    Returns:
      Five ``(H, W)`` tensors, then the ``(H, W, 3)`` unit ray directions
      in model space (rays from :func:`model_eye`) that the march used.
      With ``refine_steps > 0``: ``(found (bool), t_surf, gA, gS, gL)``,
      the refined eye distance and the central differences of ±1 voxel
      along the plan's (principal, sub, lane) axes in the prepared
      layout. With ``refine_steps == 0``: ``(found, t_hit, f_lo, f_hi,
      0)``, the sample that crossed and ``f = value − iso`` at it and at
      the active sample before it, for the torch solvers. A ray without a
      crossing holds zeros. A CPU volume takes :func:`iso_raymarch_plain`;
      a CUDA volume launches B6, which sets up its own rays.
    """
    dev = vol_prepared.device
    if dev.type == "cpu":
        return iso_raymarch_plain(vol_prepared, camera, iso_value,
                                  image_size, plan, refine_steps)
    if dev.type != "cuda":
        raise ValueError(f"no raymarch kernel for device {dev}")
    _build.require_cuda_tensor(vol_prepared, "vol_prepared", torch.float32,
                               dev)
    _check_prepared(vol_prepared, plan)
    if refine_steps < 0:
        raise ValueError(f"refine_steps {refine_steps} < 0")
    params = _iso_params(plan, camera, iso_value, image_size)
    width, height = image_size
    out = torch.empty((5, height, width), dtype=torch.float32, device=dev)
    directions = torch.empty((height, width, 3), dtype=torch.float32,
                             device=dev)
    if out.numel() == 0:
        return (out[0] > 0.5,) + tuple(out[1:]) + (directions,)
    planes, sub, lane = vol_prepared.shape
    lib = _build.library()
    _build.LAUNCHES["raymarch_iso"] += 1
    err = lib.correrender_raymarch_iso(
        vol_prepared.data_ptr(), planes, sub, lane, width, height,
        params.ctypes.data, plan["axis_world"], plan["sub_axis"],
        plan["lane_axis"], plan["q"], int(refine_steps), out.data_ptr(),
        directions.data_ptr(), dev.index, _build.stream_of(out))
    _build.check(err, "raymarch_iso")
    return (out[0] > 0.5,) + tuple(out[1:]) + (directions,)
