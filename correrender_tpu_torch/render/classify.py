"""Transfer-function classification through two-hot (tent) weights.

Counterpart of ``correrender_tpu/render/classify.py``. The linearly
interpolated LUT read ``rgba(v) = (1−f)·lut[i] + f·lut[i+1]`` is written
as a two-hot weight row over the LUT bins times the LUT. This plain f32
form is the reference the classify kernel (K2,
``ops/cuda/csrc/classify.cu``) is held to.
"""

from __future__ import annotations

import numpy as np
import torch


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
