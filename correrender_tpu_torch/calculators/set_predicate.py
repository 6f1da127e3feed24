"""Set-predicate calculator: per-voxel member-set predicates.

Counterpart of ``correrender_tpu/calculators/set_predicate.py``
(reference src/Calculators/SetPredicateCalculator.* +
SetPredicateCalculator.glsl): a comparison predicate per member,
aggregated {count, fraction, any, all} over the ensemble axis, or the
reference's count ramp (``count_range``). The member stack is read
Z-slab by Z-slab in float32 (``base.stack_slabs``).
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.calculators.base import (
    Calculator,
    register_calculator_type,
    stack_slabs,
)

COMPARISONS = {
    "greater": lambda v, a, b: v > a,
    "greater_equal": lambda v, a, b: v >= a,
    "less": lambda v, a, b: v < a,
    "less_equal": lambda v, a, b: v <= a,
    "equal": lambda v, a, b: v == a,
    "not_equal": lambda v, a, b: v != a,
    "between": lambda v, a, b: (v >= a) & (v <= b),
}

#: Reference GUI operator glyphs (COMPARISON_OPERATOR_NAMES,
#: SetPredicateCalculator.hpp:44-46) ↔ our comparison ids.
COMPARISON_GLYPHS = {
    ">": "greater",
    ">=": "greater_equal",
    "<": "less",
    "<=": "less_equal",
    "==": "equal",
    "!=": "not_equal",
}

AGGREGATIONS = {
    "count": lambda m: m.sum(-1).to(torch.float32),
    "fraction": lambda m: m.to(torch.float32).mean(-1),
    "any": lambda m: m.any(-1).to(torch.float32),
    "all": lambda m: m.all(-1).to(torch.float32),
    # "count_range" (the reference's only aggregation) is handled in
    # compute().
}


@register_calculator_type("set_predicate")
class SetPredicateCalculator(Calculator):
    def __init__(
        self,
        field_name: str | None = None,
        comparison: str = "greater",
        aggregation: str = "fraction",
        threshold: float = 0.0,
        threshold_upper: float = 1.0,
        count_lower: int = 0,
        count_upper: int = 0,
        output_name=None,
    ):
        super().__init__(output_name)
        comparison = COMPARISON_GLYPHS.get(comparison, comparison)
        if comparison not in COMPARISONS:
            raise ValueError(f"unknown comparison {comparison!r}")
        if aggregation not in AGGREGATIONS and aggregation != "count_range":
            raise ValueError(f"unknown aggregation {aggregation!r}")
        self.field_name = field_name
        self.comparison = comparison
        self.aggregation = aggregation
        self.threshold = float(threshold)
        self.threshold_upper = float(threshold_upper)
        self.count_lower = int(count_lower)
        self.count_upper = int(count_upper)

    def default_output_name(self):
        return f"Set Predicate ({self.field_name})"

    def _aggregate(self, mask: torch.Tensor) -> torch.Tensor:
        if self.aggregation != "count_range":
            return AGGREGATIONS[self.aggregation](mask)
        count = mask.sum(-1).to(torch.float32)
        lo, hi = float(self.count_lower), float(self.count_upper)
        # Reference ramp (SetPredicateCalculator.cpp:200-204 /
        # SetPredicateCalculator.glsl:64-68): a step at lo when lo == hi,
        # else a linear ramp over [lo, hi].
        if lo == hi:
            return torch.clamp(count - lo, 0.0, 1.0)
        span = torch.tensor(hi - lo, dtype=torch.float32, device=count.device)
        return torch.clamp((count - lo) / span, 0.0, 1.0)

    def compute(self, time, member):
        stack = self.volume_data.get_member_stack(
            self.field_name or self.volume_data.field_names[0], time)
        compare = COMPARISONS[self.comparison]
        return torch.cat([
            self._aggregate(compare(slab, self.threshold,
                                    self.threshold_upper))
            for _, slab in stack_slabs(stack)])

    @classmethod
    def settings_to_kwargs(cls, s):
        # Reference state-file key -> __init__ kwarg.
        out = {"field_name": s.get("scalar_field_name")}
        for k in ("comparison", "aggregation", "threshold",
                  "threshold_upper", "count_lower", "count_upper"):
            if k in s:
                out[k] = s[k]
        # Reference state-file keys (SetPredicateCalculator.cpp
        # setSettings): glyph operator + value + count window.
        if "comparison_operator_type" in s:
            out["comparison"] = s["comparison_operator_type"]
        if "comparison_value" in s:
            out["threshold"] = float(s["comparison_value"])
        if "count_lower" in s or "count_upper" in s:
            out["aggregation"] = "count_range"
        return out

    def get_settings(self):
        out = {
            "scalar_field_name": self.field_name,
            "comparison": self.comparison,
            "aggregation": self.aggregation,
            "threshold": self.threshold,
            "threshold_upper": self.threshold_upper,
        }
        if self.aggregation == "count_range":
            out["count_lower"] = self.count_lower
            out["count_upper"] = self.count_upper
        return out
