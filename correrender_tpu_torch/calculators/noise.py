"""Noise reduction: separable 3D Gaussian blur.

Counterpart of ``correrender_tpu/calculators/noise.py`` (reference
src/Calculators/NoiseReductionCalculator.* + GaussianBlur3D.glsl):
σ-configurable Gaussian smoothing of a scalar field, edge-clamped. The
JAX package runs three 1D convolutions; here each axis is 2r + 1
shifted multiply-adds in float32, so no cuDNN convolution (which rounds
its inputs to TF32 by default) takes part.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from correrender_tpu_torch.calculators.base import (
    Calculator,
    register_calculator_type,
)


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    if sigma <= 0.0:
        # σ → 0 limit is the identity; the naive formula gives 0/0 = NaN
        # at the centre tap (a state file may carry standard_deviation 0).
        return np.ones(1, np.float32)
    radius = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur_3d(vol: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of a ``(Z, Y, X)`` volume, edge-clamped,
    axis 0 first (the JAX package's order)."""
    taps = [float(w) for w in gaussian_kernel_1d(sigma)]
    r = len(taps) // 2
    out = vol
    for axis in range(3):
        size = out.shape[axis]
        idx = torch.clamp(torch.arange(-r, size + r, device=out.device),
                          0, size - 1)
        padded = out.index_select(axis, idx)
        acc = padded.narrow(axis, 0, size) * taps[0]
        for k in range(1, len(taps)):
            acc = acc + padded.narrow(axis, k, size) * taps[k]
        out = acc
    return out


@register_calculator_type("noise_reduction")
class NoiseReductionCalculator(Calculator):
    def __init__(self, field_name: str | None = None, sigma: float = 1.0,
                 output_name=None):
        super().__init__(output_name)
        self.field_name = field_name
        self.sigma = float(sigma)

    def default_output_name(self):
        return f"Noise Reduction ({self.field_name})"

    def compute(self, time: int, member: int):
        vol = self.volume_data.get_field(
            self.field_name or self.volume_data.field_names[0], time, member)
        return gaussian_blur_3d(vol, self.sigma)

    @classmethod
    def settings_to_kwargs(cls, s):
        kwargs = {}
        if "scalar_field_name" in s:
            kwargs["field_name"] = s["scalar_field_name"]
        if "standard_deviation" in s:
            kwargs["sigma"] = float(s["standard_deviation"])
        return kwargs

    def get_settings(self):
        return {
            "scalar_field_name": self.field_name,
            "standard_deviation": self.sigma,
        }
