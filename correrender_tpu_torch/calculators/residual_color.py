"""Residual colour calculator: colour-mapped signed difference.

Counterpart of ``correrender_tpu/calculators/residual_color.py``
(reference src/Calculators/ResidualColorCalculator.* +
ResidualColorCalculator.glsl): the signed difference of two fields,
scaled by its largest magnitude, through a diverging transfer function,
as a ``FieldType.COLOR`` ``(Z, Y, X, 4)`` field on the volume's device.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.calculators.base import (
    Calculator,
    register_calculator_type,
)
from correrender_tpu_torch.core.fields import FieldType
from correrender_tpu_torch.render.tf import TransferFunction


@register_calculator_type("residual_color")
class ResidualColorCalculator(Calculator):
    output_type = FieldType.COLOR

    def __init__(
        self,
        field_name_a: str | None = None,
        field_name_b: str | None = None,
        colormap: str = "coolwarm",
        output_name=None,
    ):
        super().__init__(output_name)
        self.field_name_a = field_name_a
        self.field_name_b = field_name_b
        self.colormap = colormap

    def default_output_name(self):
        return f"Residual Color ({self.field_name_a} - {self.field_name_b})"

    def compute(self, time, member):
        vd = self.volume_data
        a = vd.get_field(self.field_name_a, time, member)
        b = vd.get_field(self.field_name_b, time, member)
        diff = a - b
        # Symmetric domain around 0 like the reference (divergent map);
        # the bound stays a device scalar (no host sync).
        mag = diff.abs()
        bound = torch.clamp_min(
            torch.where(torch.isnan(mag), -torch.inf, mag).amax(), 1e-30)
        tf = TransferFunction.from_colormap(self.colormap, domain=(-1.0, 1.0),
                                            device=diff.device)
        return tf(diff / bound)

    @classmethod
    def settings_to_kwargs(cls, s):
        # Reference state-file keys -> __init__ kwargs.
        out = {
            "field_name_a": s.get("scalar_field_name_0"),
            "field_name_b": s.get("scalar_field_name_1"),
        }
        if "colormap" in s:
            out["colormap"] = s["colormap"]
        return out

    def get_settings(self):
        return {
            "scalar_field_name_0": self.field_name_a,
            "scalar_field_name_1": self.field_name_b,
            "colormap": self.colormap,
        }
