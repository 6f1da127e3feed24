"""Correlation-measure registry and unified dispatch.

Counterpart of ``correrender_tpu/ops/registry.py``. The measure enum and
string ids mirror the reference (src/Calculators/CorrelationDefines.hpp:
41-75) so state files stay compatible; only Pearson is ported so far.
"""

from __future__ import annotations

import enum

import torch

from correrender_tpu_torch.ops.pearson import pearson


class CorrelationMeasure(enum.Enum):
    PEARSON = "pearson"
    SPEARMAN = "spearman"
    KENDALL = "kendall"
    MUTUAL_INFORMATION_BINNED = "mi_binned"
    MUTUAL_INFORMATION_KRASKOV = "mi_kraskov"
    BINNED_MI_CORRELATION_COEFFICIENT = "binned_mi_correlation_coefficient"
    KMI_CORRELATION_COEFFICIENT = "kmi_correlation_coefficient"


# The ROADMAP step that ports each measure not ported yet.
_ROADMAP_STEP = {
    CorrelationMeasure.SPEARMAN: "A.8",
    CorrelationMeasure.KENDALL: "A.8",
    CorrelationMeasure.MUTUAL_INFORMATION_BINNED: "A.9",
    CorrelationMeasure.MUTUAL_INFORMATION_KRASKOV: "A.9",
    CorrelationMeasure.BINNED_MI_CORRELATION_COEFFICIENT: "A.9",
    CorrelationMeasure.KMI_CORRELATION_COEFFICIENT: "A.9",
}


def measure_from_id(measure_id) -> CorrelationMeasure:
    if isinstance(measure_id, CorrelationMeasure):
        return measure_id
    return CorrelationMeasure(str(measure_id))


def require_ported(m: CorrelationMeasure) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP step for a
    measure that is not ported yet."""
    if m in _ROADMAP_STEP:
        raise NotImplementedError(
            f"measure {m.value!r} is not ported yet "
            f"(ROADMAP {_ROADMAP_STEP[m]})")


def correlate(
    x: torch.Tensor,
    y: torch.Tensor,
    measure: CorrelationMeasure | str = CorrelationMeasure.PEARSON,
    *,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Correlation of ``x`` and ``y`` along the last axis (leading axes
    broadcast), accumulated in ``dtype``."""
    m = measure_from_id(measure)
    require_ported(m)
    return pearson(x, y, dtype=dtype)
