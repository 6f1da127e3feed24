"""Ensemble mean / spread calculators.

Counterpart of ``correrender_tpu/calculators/ensemble.py`` (reference
src/Calculators/EnsembleMeanCalculator.* and EnsembleSpreadCalculator.*):
per-voxel mean and population standard deviation over the ensemble
axis, NaN members ignored. A bfloat16 member stack is reduced in
float32, Z-slab by Z-slab (``base.stack_slabs``).
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.calculators.base import (
    Calculator,
    register_calculator_type,
    stack_slabs,
)


class _EnsembleBase(Calculator):
    def __init__(self, field_name: str | None = None, output_name=None):
        super().__init__(output_name)
        self.field_name = field_name

    def _reduce(self, time: int, fn) -> torch.Tensor:
        stack = self.volume_data.get_member_stack(
            self.field_name or self.volume_data.field_names[0], time)
        return torch.cat([fn(slab) for _, slab in stack_slabs(stack)])

    @classmethod
    def settings_to_kwargs(cls, s):
        # Reference state-file key -> __init__ kwarg.
        return {"field_name": s.get("scalar_field_name")}

    def get_settings(self):
        return {"scalar_field_name": self.field_name}


@register_calculator_type("ensemble_mean")
class EnsembleMeanCalculator(_EnsembleBase):
    def default_output_name(self):
        return f"Ensemble Mean ({self.field_name})"

    def compute(self, time: int, member: int):
        return self._reduce(time, lambda s: torch.nanmean(s, dim=-1))


def _spread(slab: torch.Tensor) -> torch.Tensor:
    mean = torch.nanmean(slab, dim=-1, keepdim=True)
    return torch.sqrt(torch.nanmean((slab - mean) ** 2, dim=-1))


@register_calculator_type("ensemble_spread")
class EnsembleSpreadCalculator(_EnsembleBase):
    """Per-voxel ensemble standard deviation (population, like the
    reference's EnsembleSpreadCalculator.glsl)."""

    def default_output_name(self):
        return f"Ensemble Spread ({self.field_name})"

    def compute(self, time: int, member: int):
        return self._reduce(time, _spread)
