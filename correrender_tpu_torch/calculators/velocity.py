"""Velocity-derived fields: the velocity vector, its magnitude,
vorticity and helicity.

Counterpart of ``correrender_tpu/calculators/velocity.py`` (reference
src/Calculators/VelocityCalculator.{hpp,cpp}), derived from u/v/w wind
components; ``io.load_volume`` registers magnitude, vorticity and
helicity when u/v/w (or U/V/W) exist (VolumeData.cpp:715-747). Spatial
derivatives are central differences over the grid spacing, one-sided at
the boundary slices.

Each difference is divided by the spacing as a tensor: PyTorch on a GPU
divides by a Python number as a product with its reciprocal, and the
card and the CPU would round apart.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.calculators.base import (
    Calculator,
    register_calculator_type,
)
from correrender_tpu_torch.core.fields import FieldType


def _central_diff(f: torch.Tensor, axis: int, spacing: float) -> torch.Tensor:
    """Central difference with one-sided stencils at the boundaries."""
    def div(num, den):
        return num / torch.tensor(den, dtype=f.dtype, device=f.device)

    upper = torch.roll(f, -1, axis)
    lower = torch.roll(f, 1, axis)
    out = div(upper - lower, 2.0 * spacing)
    n = f.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = n
    idx = torch.arange(n, device=f.device).reshape(shape)
    out = torch.where(idx == 0, div(upper - f, spacing), out)
    return torch.where(idx == n - 1, div(f - lower, spacing), out)


def curl(u, v, w, dx=1.0, dy=1.0, dz=1.0):
    """Vorticity vector of a ``(Z, Y, X)`` velocity field (axes 0 = z,
    1 = y, 2 = x)."""
    dw_dy = _central_diff(w, 1, dy)
    dv_dz = _central_diff(v, 0, dz)
    du_dz = _central_diff(u, 0, dz)
    dw_dx = _central_diff(w, 2, dx)
    dv_dx = _central_diff(v, 2, dx)
    du_dy = _central_diff(u, 1, dy)
    return (dw_dy - dv_dz, du_dz - dw_dx, dv_dx - du_dy)


class _VelocityBase(Calculator):
    def __init__(self, u="u", v="v", w="w", output_name=None):
        super().__init__(output_name)
        self.u, self.v, self.w = u, v, w

    def get_settings(self) -> dict:
        return {"u_field": self.u, "v_field": self.v, "w_field": self.w}

    @classmethod
    def settings_to_kwargs(cls, s: dict) -> dict:
        return {
            "u": s.get("u_field", "u"),
            "v": s.get("v_field", "v"),
            "w": s.get("w_field", "w"),
        }

    def _uvw(self, time, member):
        vd = self.volume_data
        return (vd.get_field(self.u, time, member),
                vd.get_field(self.v, time, member),
                vd.get_field(self.w, time, member))

    def _curl(self, time, member):
        u, v, w = self._uvw(time, member)
        g = self.volume_data.grid
        return (u, v, w), curl(u, v, w, g.dx, g.dy, g.dz)


@register_calculator_type("velocity")
class VelocityCalculator(_VelocityBase):
    """Stacks u/v/w into a ``(Z, Y, X, 3)`` vector field."""

    output_type = FieldType.VECTOR

    def default_output_name(self):
        return "Velocity"

    def compute(self, time, member):
        return torch.stack(self._uvw(time, member), dim=-1)


@register_calculator_type("vector_magnitude")
class VelocityMagnitudeCalculator(_VelocityBase):
    def default_output_name(self):
        return "Vector Magnitude"

    def compute(self, time, member):
        u, v, w = self._uvw(time, member)
        return torch.sqrt(u * u + v * v + w * w)


@register_calculator_type("vorticity")
class VorticityCalculator(_VelocityBase):
    def default_output_name(self):
        return "Vorticity"

    def compute(self, time, member):
        _, (cx, cy, cz) = self._curl(time, member)
        return torch.sqrt(cx * cx + cy * cy + cz * cz)


@register_calculator_type("helicity")
class HelicityCalculator(_VelocityBase):
    def default_output_name(self):
        return "Helicity"

    def compute(self, time, member):
        (u, v, w), (cx, cy, cz) = self._curl(time, member)
        return u * cx + v * cy + w * cz
