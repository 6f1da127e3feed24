"""Correlation-measure registry and unified dispatch.

Counterpart of ``correrender_tpu/ops/registry.py``. The measure enum and
string ids mirror the reference (src/Calculators/CorrelationDefines.hpp:
41-75) so state files stay compatible. The JAX package's
``correlate_jit`` and ``hashable_kwargs`` key its cache of compiled
programs; PyTorch runs eagerly, so they have no counterpart here.
"""

from __future__ import annotations

import enum

import torch

from correrender_tpu_torch.ops.kendall import kendall
from correrender_tpu_torch.ops.mi_binned import (
    binned_mi_correlation_coefficient,
    mutual_information_binned,
)
from correrender_tpu_torch.ops.mi_ksg import (
    kmi_correlation_coefficient,
    mutual_information_kraskov,
)
from correrender_tpu_torch.ops.pearson import pearson
from correrender_tpu_torch.ops.spearman import spearman


class CorrelationMeasure(enum.Enum):
    PEARSON = "pearson"
    SPEARMAN = "spearman"
    KENDALL = "kendall"
    MUTUAL_INFORMATION_BINNED = "mi_binned"
    MUTUAL_INFORMATION_KRASKOV = "mi_kraskov"
    BINNED_MI_CORRELATION_COEFFICIENT = "binned_mi_correlation_coefficient"
    KMI_CORRELATION_COEFFICIENT = "kmi_correlation_coefficient"


MEASURE_IDS = {m: m.value for m in CorrelationMeasure}
MEASURE_NAMES = {
    CorrelationMeasure.PEARSON: "Pearson",
    CorrelationMeasure.SPEARMAN: "Spearman",
    CorrelationMeasure.KENDALL: "Kendall",
    CorrelationMeasure.MUTUAL_INFORMATION_BINNED: "Mutual Information (Binned)",
    CorrelationMeasure.MUTUAL_INFORMATION_KRASKOV: "Mutual Information (Kraskov)",
    CorrelationMeasure.BINNED_MI_CORRELATION_COEFFICIENT: "Binned MI Correlation Coefficient",
    CorrelationMeasure.KMI_CORRELATION_COEFFICIENT: "KMI Correlation Coefficient",
}


def measure_from_id(measure_id) -> CorrelationMeasure:
    if isinstance(measure_id, CorrelationMeasure):
        return measure_id
    return CorrelationMeasure(str(measure_id))


def is_measure_binned_mi(m: CorrelationMeasure) -> bool:
    return m in (CorrelationMeasure.MUTUAL_INFORMATION_BINNED,
                 CorrelationMeasure.BINNED_MI_CORRELATION_COEFFICIENT)


def is_measure_kraskov_mi(m: CorrelationMeasure) -> bool:
    return m in (CorrelationMeasure.MUTUAL_INFORMATION_KRASKOV,
                 CorrelationMeasure.KMI_CORRELATION_COEFFICIENT)


def is_measure_mi(m: CorrelationMeasure) -> bool:
    return is_measure_binned_mi(m) or is_measure_kraskov_mi(m)


def is_measure_correlation_coefficient_mi(m: CorrelationMeasure) -> bool:
    return m in (CorrelationMeasure.BINNED_MI_CORRELATION_COEFFICIENT,
                 CorrelationMeasure.KMI_CORRELATION_COEFFICIENT)


def correlate(
    x: torch.Tensor,
    y: torch.Tensor,
    measure: CorrelationMeasure | str = CorrelationMeasure.PEARSON,
    *,
    num_bins: int = 80,
    k: int = 3,
    kraskov_estimator: int = 1,
    mi_bounds=None,
    dtype: torch.dtype | None = None,
    absolute: bool = False,
) -> torch.Tensor:
    """Correlation of ``x`` and ``y`` along the last axis (leading axes
    broadcast).

    Args:
      measure: a :class:`CorrelationMeasure` or its string id.
      num_bins: bins of the binned-MI measures.
      k: neighbour count of the Kraskov measures.
      kraskov_estimator: 1 or 2.
      mi_bounds: optional global ``(min, max)``, or one pair per series
        ``((xmin, xmax), (ymin, ymax))``, normalizing the binned-MI
        inputs to [0, 1] (the reference normalizes by the global field
        range, CorrelationCalculator.cpp:820-845); by default each
        series' own range.
      dtype: accumulator dtype. Kendall takes None as its own rule (an
        integer accumulator past n ≈ 4000); Spearman sums exact integers
        and takes none; the others default to float32.
      absolute: return |value|.
    """
    m = measure_from_id(measure)
    acc = torch.float32 if dtype is None else dtype
    if m == CorrelationMeasure.PEARSON:
        out = pearson(x, y, dtype=acc)
    elif m == CorrelationMeasure.SPEARMAN:
        out = spearman(x, y)
    elif m == CorrelationMeasure.KENDALL:
        out = kendall(x, y, dtype=dtype)
    elif is_measure_binned_mi(m):
        if mi_bounds is not None:
            (xmin, xmax), (ymin, ymax) = split_bounds(mi_bounds)
            xn = _scale01(x, xmin, xmax)
            yn = _scale01(y, ymin, ymax)
        else:
            xn, yn = _normalize01(x), _normalize01(y)
        out = mutual_information_binned(xn, yn, num_bins=num_bins, dtype=acc)
        if m == CorrelationMeasure.BINNED_MI_CORRELATION_COEFFICIENT:
            out = binned_mi_correlation_coefficient(out)
    else:
        out = mutual_information_kraskov(x, y, k=k,
                                         estimator=kraskov_estimator)
        if m == CorrelationMeasure.KMI_CORRELATION_COEFFICIENT:
            out = kmi_correlation_coefficient(out)
    return out.abs() if absolute else out


def _scale01(v: torch.Tensor, lo, hi) -> torch.Tensor:
    """``(v − lo) / (hi − lo)`` with the span as a tensor: PyTorch on a
    GPU divides by a Python number as a product with its reciprocal,
    which moves values on a bin edge into the next bin."""
    span = torch.as_tensor(hi - lo, dtype=v.dtype, device=v.device)
    return (v - lo) / span


def _normalize01(v: torch.Tensor) -> torch.Tensor:
    vmin = v.amin(-1, keepdim=True)
    vmax = v.amax(-1, keepdim=True)
    return (v - vmin) / torch.clamp(vmax - vmin, min=1e-30)


def split_bounds(mi_bounds):
    """``(min, max)`` for both series, or ``((xmin, xmax), (ymin, ymax))``."""
    if isinstance(mi_bounds[0], (tuple, list)):
        return mi_bounds
    return (mi_bounds, mi_bounds)
