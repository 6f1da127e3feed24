"""Transfer-function classification through two-hot (tent) weights.

Counterpart of ``correrender_tpu/render/classify.py``. The linearly
interpolated LUT read ``rgba(v) = (1−f)·lut[i] + f·lut[i+1]`` is written
as a two-hot weight row over the LUT bins times the LUT. This plain f32
form is the reference the classify kernels (K2 and B3,
``ops/cuda/csrc/classify.cu``) are held to.

:func:`classify_volume` is B3's wrapper, beside its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.ops.cuda import _build

# z-slices per step of the plain classify_volume: bounds the (…, R)
# two-hot weights.
_CLASSIFY_SLAB = 8


def two_hot_weights(values: torch.Tensor, domain,
                    resolution: int) -> torch.Tensor:
    """Tent (two-hot) LUT-bin weights, ``values.shape + (resolution,)``.

    Rows sum to 1 for finite inputs, 0 for NaN. A degenerate domain
    (hi ≤ lo, e.g. a constant field) maps every finite value to bin 0
    instead of producing 0/0 = NaN weights.
    """
    lo, hi = (np.float32(d) for d in domain)
    span = float(hi - lo)  # in f32, as the kernel computes it
    lo = float(lo)
    if span > 0:
        u = torch.clamp((values - lo) / span, 0.0, 1.0) * (resolution - 1)
    else:
        u = torch.zeros_like(values)
    u = torch.where(torch.isnan(values), -2.0, u)  # outside every tent
    bins = torch.arange(resolution, dtype=torch.float32,
                        device=values.device)
    return torch.clamp_min(1.0 - (u[..., None] - bins).abs(), 0.0)


def premultiplied(lut: torch.Tensor) -> torch.Tensor:
    """``(R, 4)`` straight-alpha LUT → ``(r·a, g·a, b·a, a)``."""
    return torch.cat([lut[:, :3] * lut[:, 3:4], lut[:, 3:4]], dim=-1)


def classify(scalars: torch.Tensor, lut: torch.Tensor, domain,
             premultiply: bool = True) -> torch.Tensor:
    """Map scalars through a LUT transfer function.

    Args:
      scalars: any-shape float32 scalar field.
      lut: ``(R, 4)`` RGBA LUT (straight alpha).
      domain: host ``(lo, hi)`` value range mapped onto the LUT.
      premultiply: return ``(r·a, g·a, b·a, a)``, the form the shear-warp
        compositor interpolates without colour bleeding.

    Returns:
      ``scalars.shape + (4,)`` float32; NaN scalars map to 0.
    """
    w = two_hot_weights(scalars, domain, lut.shape[0])
    out_lut = premultiplied(lut) if premultiply else lut
    return torch.einsum("...r,rc->...c", w, out_lut)


def classify_volume_plain(volume: torch.Tensor, lut: torch.Tensor,
                          domain) -> torch.Tensor:
    """Plain version of B3: :func:`classify` (premultiplied) of a
    ``(Z, Y, X)`` field, chunked over z to bound the two-hot weights."""
    return torch.cat([
        classify(volume[z0:z0 + _CLASSIFY_SLAB], lut, domain)
        for z0 in range(0, volume.shape[0], _CLASSIFY_SLAB)
    ])


def classify_volume(volume: torch.Tensor, lut: torch.Tensor,
                    domain) -> torch.Tensor:
    """Classify a ``(Z, Y, X)`` field into premultiplied RGBA.

    Counterpart of ``correrender_tpu/render/classify.py::classify_volume``
    (the TPU runs ``classify_pallas`` there).

    Args:
      volume: ``(Z, Y, X)`` float32 field, contiguous.
      lut: ``(R, 4)`` float32 straight-alpha LUT on the field's device.
      domain: host ``(lo, hi)`` mapped onto the LUT.

    Returns:
      ``(Z, Y, X, 4)`` float32 premultiplied RGBA; NaN → 0, a degenerate
      domain → bin 0. A CPU field takes :func:`classify_volume_plain`; a
      CUDA field launches kernel B3 (``csrc/classify.cu``).
    """
    lo, hi = (float(d) for d in domain)
    if volume.device.type == "cpu":
        return classify_volume_plain(volume, lut, (lo, hi))
    if volume.device.type != "cuda":
        raise ValueError(f"no classify kernel for device {volume.device}")
    if volume.dim() != 3:
        raise ValueError(f"volume has shape {tuple(volume.shape)}, "
                         "expected (Z, Y, X)")
    if lut.dim() != 2 or lut.shape[1] != 4:
        raise ValueError(f"lut has shape {tuple(lut.shape)}, expected (R, 4)")
    _build.require_cuda_tensor(volume, "volume", torch.float32, volume.device)
    lutp = premultiplied(lut).contiguous()
    _build.require_cuda_tensor(lutp, "lut", torch.float32, volume.device)
    out = torch.empty(tuple(volume.shape) + (4,), dtype=torch.float32,
                      device=volume.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    _build.LAUNCHES["classify_volume"] += 1
    err = lib.correrender_classify_volume(
        volume.data_ptr(), volume.numel(), lutp.data_ptr(), lutp.shape[0],
        lo, hi, out.data_ptr(), volume.device.index,
        _build.stream_of(volume),
    )
    _build.check(err, "classify_volume")
    return out
