"""K2 (classify into the compositor's layout, ``csrc/classify.cu``) and
K3 (the fused shear-warp compositor, ``csrc/shearwarp.cu``), each beside
its plain PyTorch version.

Counterpart of ``correrender_tpu/ops/pallas/shearwarp_kernel.py``. The
classified volume's layout is ``(S, Yv, Xv, 4)`` bf16, premultiplied:
only K3 reads it, and one RGBA tap is one 8-byte load. The TPU's 8×128
padding is not carried over.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.render.classify import (
    classify_volume_plain,
    premultiplied,
)

_EPS = 1e-6
# Slices per step of the plain composite: bounds its (chunk, hi, wi, 4)
# slab.
_COMPOSITE_CHUNK = 16


def _oriented(volume: torch.Tensor, perm, flip: bool) -> torch.Tensor:
    svol = volume.permute(*perm)
    return svol.flip(0) if flip else svol


def classify_to_cf_plain(volume, perm, flip, lut, domain) -> torch.Tensor:
    """Plain version of K2: the f32 two-hot reference
    (:func:`render.classify.classify_volume_plain`) of the slice-oriented
    field, stored as bf16."""
    return classify_volume_plain(_oriented(volume, perm, flip), lut,
                                 domain).to(torch.bfloat16)


def classify_to_cf(volume: torch.Tensor, perm, flip: bool,
                   lut: torch.Tensor, domain) -> torch.Tensor:
    """Classify a ``(Z, Y, X)`` field into the compositor's layout.

    Args:
      volume: ``(Z, Y, X)`` float32 scalar field (any strides).
      perm: array axes ``(slice, v, u)`` of the shear-warp orientation.
      flip: reverse the slice axis (slices ordered near → far).
      lut: ``(R, 4)`` float32 straight-alpha LUT on the field's device.
      domain: host ``(lo, hi)`` mapped onto the LUT.

    Returns:
      ``(S, Yv, Xv, 4)`` bf16 premultiplied RGBA. A CPU field takes
      :func:`classify_to_cf_plain`; a CUDA field launches K2, which reads
      the field through the orientation's strides (no transposed copy).
    """
    lo, hi = (float(d) for d in domain)
    if volume.device.type == "cpu":
        return classify_to_cf_plain(volume, perm, flip, lut, (lo, hi))
    if volume.device.type != "cuda":
        raise ValueError(f"no classify kernel for device {volume.device}")
    if volume.dtype != torch.float32 or volume.dim() != 3:
        raise TypeError("classify_to_cf takes a float32 (Z, Y, X) field")
    if lut.dim() != 2 or lut.shape[1] != 4:
        raise ValueError(f"lut has shape {tuple(lut.shape)}, expected (R, 4)")
    lutp = premultiplied(lut).contiguous()
    _build.require_cuda_tensor(lutp, "lut", torch.float32, volume.device)
    s, yv, xv = (volume.shape[p] for p in perm)
    st_s, st_v, st_u = (volume.stride(p) for p in perm)
    if s > 65535:
        raise ValueError(f"{s} slices exceed the kernel's grid")
    offset = 0
    if flip:
        offset, st_s = (s - 1) * st_s, -st_s
    out = torch.empty((s, yv, xv, 4), dtype=torch.bfloat16,
                      device=volume.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    _build.LAUNCHES["classify_to_cf"] += 1
    err = lib.correrender_classify_cf(
        volume.data_ptr(), offset, st_s, st_v, st_u, s, yv, xv,
        lutp.data_ptr(), lutp.shape[0], lo, hi, out.data_ptr(),
        volume.device.index, _build.stream_of(volume),
    )
    _build.check(err, "classify_to_cf")
    return out


def prepare_cvol_cf(cvol: torch.Tensor) -> torch.Tensor:
    """An oriented classified volume ``(S, Yv, Xv, 4)`` float32 (slices
    near → far, premultiplied) in the compositor's layout: contiguous
    bf16, the form :func:`classify_to_cf` produces. Counterpart of the
    JAX package's ``prepare_cvol_cf`` without its 8×128 padding."""
    if cvol.dim() != 4 or cvol.shape[-1] != 4:
        raise ValueError(f"cvol has shape {tuple(cvol.shape)}, expected "
                         "(S, Yv, Xv, 4)")
    return cvol.to(torch.bfloat16, memory_format=torch.contiguous_format)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round f32 values to the nearest bf16 value, kept in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def shearwarp_composite_plain(
    cf, g, coords_y, coords_x, grid_v, grid_u, eye_uv, len_factor,
    slab_thickness: float, attenuation: float, kstop=None,
):
    """Plain version of K3: the reference compositor
    (``render/dvr_fast.py::_composite_scan``) in PyTorch.

    Per chunk of slices, the separable tent resample is two dense
    weight-matrix products with the reference's rounding (bf16 weights,
    bf16 between the two passes, f32 sums); the chunk is then composited
    front to back through its cumulative transmittance.
    """
    s, yv, xv, _ = cf.shape
    hi, wi = len_factor.shape
    e_u, e_v = (float(e) for e in eye_uv)
    dy = coords_y[1] - coords_y[0] if yv > 1 else 1.0
    dx = coords_x[1] - coords_x[0] if xv > 1 else 1.0
    acc_rgb = torch.zeros((hi, wi, 3), dtype=torch.float32,
                          device=cf.device)
    acc_a = torch.zeros((hi, wi), dtype=torch.float32, device=cf.device)
    for k0 in range(0, s, _COMPOSITE_CHUNK):
        k1 = k0 + _COMPOSITE_CHUNK
        gk = g[k0:k1]
        qv = e_v + (grid_v[None, :] - e_v) * gk[:, None]
        qu = e_u + (grid_u[None, :] - e_u) * gk[:, None]
        wv = round_bf16(torch.clamp_min(
            1.0 - (qv[..., None] - coords_y).abs() / dy, 0.0))
        wu = round_bf16(torch.clamp_min(
            1.0 - (qu[..., None] - coords_x).abs() / dx, 0.0))
        slab = round_bf16(torch.einsum(
            "kiy,kyxc->kixc", wv, cf[k0:k1].to(torch.float32)))
        slab = torch.einsum("kixc,kjx->kijc", slab, wu)  # (c, hi, wi, 4)
        tau = slab[..., 3]
        thickness = slab_thickness * len_factor[None]
        if kstop is not None:
            kidx = torch.arange(k0, k0 + gk.shape[0], dtype=torch.float32,
                                device=cf.device)
            thickness = thickness * torch.clamp(
                kstop[None] - kidx[:, None, None], 0.0, 1.0)
        valid = (gk > _EPS).to(torch.float32)[:, None, None]
        alpha = (1.0 - torch.exp(-tau * thickness * attenuation)) * valid
        rgb = alpha[..., None] * (
            slab[..., :3] / torch.clamp_min(tau, _EPS)[..., None])
        # Front-to-back OVER of the chunk: slice k is seen through the
        # transmittance of the slices in front of it.
        trans = torch.cumprod(1.0 - alpha, dim=0)
        before = torch.cat([torch.ones_like(trans[:1]), trans[:-1]])
        acc_rgb = acc_rgb + (1.0 - acc_a)[..., None] * (
            before[..., None] * rgb).sum(0)
        acc_a = acc_a + (1.0 - acc_a) * (1.0 - trans[-1])
    return acc_rgb, acc_a


def shearwarp_composite(
    cf, g, coords_y, coords_x, grid_v, grid_u, eye_uv, len_factor,
    slab_thickness: float, attenuation: float, kstop=None,
):
    """Fused shear-warp composite of a classified slice volume.

    Args:
      cf: ``(S, Yv, Xv, 4)`` bf16 premultiplied slices, near → far
        (:func:`classify_to_cf`).
      g: ``(S,)`` through-eye scale per slice.
      coords_y, coords_x: ``(Yv,)``, ``(Xv,)`` voxel-centre world coords.
      grid_v, grid_u: ``(hi,)``, ``(wi,)`` intermediate-grid world coords.
      eye_uv: host ``(e_u, e_v)``, the eye's in-plane coords.
      len_factor: ``(hi, wi)`` path-length factor per pixel.
      slab_thickness, attenuation: host floats.
      kstop: optional ``(hi, wi)`` fractional stop-slice indices.

    Returns:
      ``(rgb (hi, wi, 3), alpha (hi, wi))`` float32, premultiplied. CPU
      tensors take :func:`shearwarp_composite_plain`; CUDA tensors
      launch K3.
    """
    args = (cf, g, coords_y, coords_x, grid_v, grid_u, eye_uv, len_factor,
            slab_thickness, attenuation, kstop)
    if cf.device.type == "cpu":
        return shearwarp_composite_plain(*args)
    if cf.device.type != "cuda":
        raise ValueError(f"no composite kernel for device {cf.device}")
    s, yv, xv, four = cf.shape
    hi, wi = len_factor.shape
    dev = cf.device
    _build.require_cuda_tensor(cf, "cf", torch.bfloat16, dev)
    for name, t, shape in (
        ("g", g, (s,)), ("coords_y", coords_y, (yv,)),
        ("coords_x", coords_x, (xv,)), ("grid_v", grid_v, (hi,)),
        ("grid_u", grid_u, (wi,)), ("len_factor", len_factor, (hi, wi)),
        ("kstop", kstop, (hi, wi)),
    ):
        if t is None:
            continue
        _build.require_cuda_tensor(t, name, torch.float32, dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if four != 4:
        raise ValueError(f"cf has shape {tuple(cf.shape)}, expected "
                         "(S, Yv, Xv, 4)")
    rgb = torch.empty((hi, wi, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty((hi, wi), dtype=torch.float32, device=dev)
    if rgb.numel() == 0:
        return rgb, alpha
    e_u, e_v = (float(e) for e in eye_uv)
    # The pre-pass's tent taps: one 8-byte entry per (slice, row) and per
    # (slice, column).
    taps = torch.empty((s * (hi + wi), 2), dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.LAUNCHES["shearwarp_composite"] += 1
    err = lib.correrender_shearwarp_composite(
        cf.data_ptr(), s, yv, xv, g.data_ptr(), coords_y.data_ptr(),
        coords_x.data_ptr(), grid_v.data_ptr(), grid_u.data_ptr(),
        len_factor.data_ptr(), None if kstop is None else kstop.data_ptr(),
        hi, wi, e_u, e_v, float(slab_thickness), float(attenuation),
        taps.data_ptr(), rgb.data_ptr(), alpha.data_ptr(), dev.index,
        _build.stream_of(cf),
    )
    _build.check(err, "shearwarp_composite")
    return rgb, alpha
