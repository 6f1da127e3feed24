"""The shear-warp's homography warp (``csrc/warp.cu``) beside its plain
PyTorch version.

The intermediate image, composited on the reference plane, maps to the
screen by a projective map with a shared affine denominator:

    su(px,py) = (A0 + A1·px + A2·py) / (C0 + C1·px + C2·py)
    sv(px,py) = (B0 + B1·px + B2·py) / (C0 + C1·px + C2·py)

It factors into two passes of per-line 1D tent resampling
(Catmull–Smith):

    pass A:  T(a, y)   = I(u(a, y), y)      with sv(a, py*) = y
    pass B:  S(px, py) = T(px, sv(px, py))

then a mask to forward rays and a blend OVER the background. The JAX
package leaves the passes to XLA as dense tent-weight products
(``correrender_tpu/render/dvr_fast.py::_warp_matmul``); the plain
version keeps that form, and the kernel computes each screen pixel from
the two nonzero taps of each pass. Which of the four factorizations
(intermediate transposed, screen transposed) runs is
:func:`render.dvr_fast.warp_to_screen`'s choice.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.shearwarp_kernel import round_bf16
from correrender_tpu_torch.ops.precision import f32_matmul
from correrender_tpu_torch.render.dvr import blend_background

_WARP_CHUNK = 16  # rows (pass A) or columns (pass B) per plain product
_INT32_MAX = 2**31 - 1


def variant_coeffs(coeffs, t_int: bool, t_out: bool) -> list:
    """The ``(A, B, C)`` coefficient triplets of one pass order, as the
    float32 values both versions compute with.

    ``coeffs`` are the screen → intermediate triplets over ``(px, py)``
    and ``(su, sv)``; ``t_int`` swaps the intermediate's axes (A ↔ B),
    ``t_out`` the screen's (the second and third entry of each)."""
    a, b, c = (np.asarray(x, np.float64) for x in coeffs)
    if t_int:
        a, b = b, a
    if t_out:
        a, b, c = (x[[0, 2, 1]] for x in (a, b, c))
    return [[float(np.float32(v)) for v in x] for x in (a, b, c)]


def _safe(den):
    return torch.where(den.abs() < 1e-12, 1e-12, den)


def _tent(coord: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """bf16-rounded tent weights ``max(1 − |coord − tap|, 0)``."""
    return round_bf16(torch.clamp_min(1.0 - (coord - taps).abs(), 0.0))


# The reference rounds tent weights and image to bf16 and sums the
# products in f32. TF32 holds bf16 values exactly, so it would not change
# the products, only the kernel and its summation order: pinned off.
@f32_matmul()
def warp_two_pass_plain(rgb, alpha, coeffs, sign_ok: float, background,
                        t_int: bool, t_out: bool, width: int, height: int):
    """Plain version of the warp: each pass as dense tent weights
    contracted with the image by ``bmm``, in row or column chunks (the
    full ``(Hi, Wo, Wi)`` weight tensor at 1080p is about 4 G elements).
    Arguments as :func:`warp_two_pass`."""
    (a0, a1, a2), (b0, b1, b2), (c0, c1, c2) = variant_coeffs(
        coeffs, t_int, t_out)
    if t_int:
        rgb, alpha = rgb.transpose(0, 1), alpha.transpose(0, 1)
    w_out, h_out = (height, width) if t_out else (width, height)
    dev = alpha.device
    hi, wi = alpha.shape
    img = round_bf16(torch.cat([rgb, alpha[..., None]], dim=-1))

    # --- pass A: T[y, a] = I[y, u(a, y)] --------------------------------
    a_idx = torch.arange(w_out, dtype=torch.float32, device=dev)
    y_idx = torch.arange(hi, dtype=torch.float32, device=dev)
    # py*(a, y): sv(a, py) = y  →  py = (y(C0+C1 a) − B0 − B1 a)/(B2 − y C2)
    num = y_idx[:, None] * (c0 + c1 * a_idx[None, :]) - (
        b0 + b1 * a_idx[None, :]
    )
    den = b2 - y_idx[:, None] * c2
    py_star = num / _safe(den)  # (Hi, Wo)
    u_den = c0 + c1 * a_idx[None, :] + c2 * py_star
    u = (a0 + a1 * a_idx[None, :] + a2 * py_star) / _safe(u_den)

    cols = torch.arange(wi, dtype=torch.float32, device=dev)
    t_img = torch.empty((hi, w_out, 4), dtype=torch.float32, device=dev)
    for r0 in range(0, hi, _WARP_CHUNK):
        r1 = r0 + _WARP_CHUNK
        w = _tent(u[r0:r1, :, None], cols)  # (c, Wo, Wi)
        t_img[r0:r1] = torch.bmm(w, img[r0:r1])
    t_img = round_bf16(t_img)

    # --- pass B: S[py, px] = T[sv(px, py), px] ---------------------------
    px = torch.arange(w_out, dtype=torch.float32, device=dev)
    py = torch.arange(h_out, dtype=torch.float32, device=dev)
    den_full = c0 + c1 * px[None, :] + c2 * py[:, None]  # (Ho, Wo)
    sv = (b0 + b1 * px[None, :] + b2 * py[:, None]) / _safe(den_full)

    rows = torch.arange(hi, dtype=torch.float32, device=dev)
    s_img = torch.empty((w_out, h_out, 4), dtype=torch.float32, device=dev)
    for x0 in range(0, w_out, _WARP_CHUNK):
        x1 = x0 + _WARP_CHUNK
        w = _tent(sv[:, x0:x1].T[..., None], rows)  # (c, Ho, Hi)
        s_img[x0:x1] = torch.bmm(w, t_img[:, x0:x1].transpose(0, 1))
    s_img = s_img.transpose(0, 1)

    # Validity: forward rays only (the tent already zeros out-of-range
    # samples, but behind-the-camera rays need the sign mask).
    valid = (den_full * sign_ok > 0).to(torch.float32)
    rgb_s = s_img[..., :3] * valid[..., None]
    # Resampling can overshoot alpha past 1 by ~2e-3 (bf16 tent
    # weights); a > 1 would make the (1 − a) background term negative.
    alpha_s = torch.clamp(s_img[..., 3] * valid, 0.0, 1.0)
    out = blend_background(rgb_s, alpha_s, background)
    return out.transpose(0, 1) if t_out else out


def warp_two_pass(rgb, alpha, coeffs, sign_ok: float, background,
                  t_int: bool, t_out: bool, width: int, height: int):
    """Warp a premultiplied intermediate image to the screen.

    Args:
      rgb, alpha: ``(Hi, Wi, 3)`` and ``(Hi, Wi)`` float32 premultiplied
        intermediate (any strides).
      coeffs: host ``(A, B, C)`` triplets of the screen → intermediate
        map (``render/dvr_fast.py::_homography_coeffs``).
      sign_ok: +1/−1, the sign a forward ray's denominator has.
      background: host straight-alpha RGBA the frame is blended over.
      t_int, t_out: the pass order (:func:`variant_coeffs`).
      width, height: the screen's size.

    Returns:
      ``(height, width, 4)`` float32 straight-alpha RGBA. CPU tensors
      take :func:`warp_two_pass_plain`; CUDA tensors launch
      ``homography_warp_kernel``, which returns a contiguous frame.
    """
    t_int, t_out = bool(t_int), bool(t_out)
    args = (rgb, alpha, coeffs, float(sign_ok), background, t_int, t_out,
            int(width), int(height))
    if alpha.device.type == "cpu":
        return warp_two_pass_plain(*args)
    if alpha.device.type != "cuda":
        raise ValueError(f"no warp kernel for device {alpha.device}")
    dev = alpha.device
    for name, t in (("rgb", rgb), ("alpha", alpha)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            "torch.float32")
    if alpha.dim() != 2 or tuple(rgb.shape) != tuple(alpha.shape) + (3,):
        raise ValueError(f"rgb, alpha have shapes {tuple(rgb.shape)}, "
                         f"{tuple(alpha.shape)}, expected (Hi, Wi, 3), "
                         "(Hi, Wi)")
    width, height = int(width), int(height)
    if height > 65535:
        raise ValueError(f"{height} rows exceed the kernel's grid")
    reach = max(sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
                for t in (rgb, alpha))
    if reach > _INT32_MAX or width * height * 4 > _INT32_MAX:
        raise ValueError("the warp kernel indexes in 32 bits: the "
                         "intermediate or the frame is too large")
    out = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    (a, b, c) = variant_coeffs(coeffs, t_int, t_out)
    params = np.concatenate([np.asarray(a + b + c + [sign_ok], np.float32),
                             np.asarray(background, np.float32).reshape(4)])
    hi, wi = alpha.shape
    lib = _build.library()
    _build.LAUNCHES["warp_to_screen"] += 1
    err = lib.correrender_warp(
        rgb.data_ptr(), *rgb.stride(), alpha.data_ptr(), *alpha.stride(),
        hi, wi, int(t_int), int(t_out), params.ctypes.data, out.data_ptr(),
        width, height, dev.index, _build.stream_of(alpha),
    )
    _build.check(err, "warp_to_screen")
    return out
