"""Binary per-voxel operator on two scalar fields.

Counterpart of ``correrender_tpu/calculators/binop.py`` (reference
src/Calculators/BinaryOperatorCalculator.{hpp,cpp}); operators
{identity, sum, difference, absolute difference, product, maximum,
minimum} (BinaryOperatorCalculator.hpp:38-43). NaN propagates through
every operator, as in JAX.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.calculators.base import (
    Calculator,
    register_calculator_type,
)

BINARY_OPERATORS = {
    "identity": lambda a, b: a,
    "sum": lambda a, b: a + b,
    "difference": lambda a, b: a - b,
    "absolute_difference": lambda a, b: torch.abs(a - b),
    "product": lambda a, b: a * b,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
}

#: GUI names used in reference state files.
BINARY_OPERATOR_NAMES = {
    "Identity": "identity",
    "Sum": "sum",
    "Difference": "difference",
    "Absolute Difference": "absolute_difference",
    "Product": "product",
    "Maximum": "maximum",
    "Minimum": "minimum",
}


@register_calculator_type("binary_operator")
class BinaryOperatorCalculator(Calculator):
    def __init__(
        self,
        field_name_a: str | None = None,
        field_name_b: str | None = None,
        operator: str = "difference",
        output_name=None,
    ):
        super().__init__(output_name)
        self.field_name_a = field_name_a
        self.field_name_b = field_name_b
        self.operator = BINARY_OPERATOR_NAMES.get(operator, operator)
        if self.operator not in BINARY_OPERATORS:
            raise ValueError(f"unknown operator {operator!r}")

    def default_output_name(self):
        return f"{self.operator}({self.field_name_a}, {self.field_name_b})"

    def compute(self, time: int, member: int):
        vd = self.volume_data
        a = vd.get_field(self.field_name_a, time, member)
        b = vd.get_field(self.field_name_b, time, member)
        return BINARY_OPERATORS[self.operator](a, b)

    @classmethod
    def settings_to_kwargs(cls, s):
        kwargs = {}
        if "operator_type" in s:
            kwargs["operator"] = s["operator_type"]
        if "scalar_field_name_0" in s:
            kwargs["field_name_a"] = s["scalar_field_name_0"]
        if "scalar_field_name_1" in s:
            kwargs["field_name_b"] = s["scalar_field_name_1"]
        return kwargs

    def get_settings(self):
        # The reference GUI name ("Absolute Difference"), which the
        # reference app's enum lookup reads; settings_to_kwargs takes
        # both.
        gui = {v: k for k, v in BINARY_OPERATOR_NAMES.items()}
        return {
            "operator_type": gui.get(self.operator, self.operator),
            "scalar_field_name_0": self.field_name_a,
            "scalar_field_name_1": self.field_name_b,
        }
