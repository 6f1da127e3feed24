"""KL-divergence calculator: per-voxel D_KL(member distribution ‖ N(0,1)).

Counterpart of ``correrender_tpu/calculators/dkl_calculator.py``
(reference src/Calculators/DKLCalculator.*): the binned or
Kozachenko-Leonenko k-NN estimator (DKLCalculator.hpp:96) of
``ops/dkl.py``, over Z-slabs of the member stack as in JAX, so no full
``(V, n)`` copy is made. The k-NN estimator sorts each slab's series,
so its working set is a few slabs; JAX's voxel chunking of its
``(V, n, n)`` distances has no counterpart.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.calculators.base import (
    Calculator,
    register_calculator_type,
    stack_slabs,
)
from correrender_tpu_torch.ops.dkl import dkl_binned, dkl_knn


@register_calculator_type("dkl_calculator")
class DKLCalculator(Calculator):
    def __init__(
        self,
        field_name: str | None = None,
        estimator: str = "binned",  # "binned" | "knn"
        num_bins: int = 80,
        k: int = 3,
        output_name=None,
    ):
        super().__init__(output_name)
        if estimator not in ("binned", "knn"):
            raise ValueError(f"unknown estimator {estimator!r}")
        self.field_name = field_name
        self.estimator = estimator
        self.num_bins = num_bins
        self.k = k

    def default_output_name(self):
        return f"KL-Divergence ({self.field_name})"

    def compute(self, time, member):
        stack = self.volume_data.get_member_stack(
            self.field_name or self.volume_data.field_names[0], time)
        n = stack.shape[-1]
        outs = []
        for _, slab in stack_slabs(stack):
            series = slab.reshape(-1, n)
            if self.estimator == "binned":
                outs.append(dkl_binned(series, num_bins=self.num_bins))
            else:
                outs.append(dkl_knn(series, k=self.k))
        return torch.cat(outs).reshape(stack.shape[:-1])

    @classmethod
    def settings_to_kwargs(cls, s):
        # Reference state-file keys -> __init__ kwargs.
        out = {"field_name": s.get("scalar_field_name")}
        if "estimator" in s:
            out["estimator"] = s["estimator"]
        if "mi_bins" in s:
            out["num_bins"] = int(s["mi_bins"])
        if "knn_neighbors" in s:
            out["k"] = int(s["knn_neighbors"])
        return out

    def get_settings(self):
        return {
            "scalar_field_name": self.field_name,
            "estimator": self.estimator,
            "mi_bins": self.num_bins,
            "knn_neighbors": self.k,
        }
