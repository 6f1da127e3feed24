"""Statistical estimators over the member axis (the last axis), batched
over every leading axis. Counterpart of ``correrender_tpu/ops``."""

from correrender_tpu_torch.ops.registry import (
    CorrelationMeasure,
    MEASURE_IDS,
    MEASURE_NAMES,
    is_measure_mi,
    is_measure_binned_mi,
    is_measure_kraskov_mi,
    is_measure_correlation_coefficient_mi,
    measure_from_id,
    correlate,
)
from correrender_tpu_torch.ops.pearson import pearson
from correrender_tpu_torch.ops.ranks import fractional_ranks
from correrender_tpu_torch.ops.spearman import spearman
from correrender_tpu_torch.ops.kendall import kendall
from correrender_tpu_torch.ops.mi_binned import mutual_information_binned
from correrender_tpu_torch.ops.mi_ksg import (
    mutual_information_kraskov,
    maximum_mutual_information_kraskov,
)
from correrender_tpu_torch.ops.dkl import dkl_binned, dkl_knn

__all__ = [
    "CorrelationMeasure",
    "MEASURE_IDS",
    "MEASURE_NAMES",
    "is_measure_mi",
    "is_measure_binned_mi",
    "is_measure_kraskov_mi",
    "is_measure_correlation_coefficient_mi",
    "measure_from_id",
    "correlate",
    "pearson",
    "fractional_ranks",
    "spearman",
    "kendall",
    "mutual_information_binned",
    "mutual_information_kraskov",
    "maximum_mutual_information_kraskov",
    "dkl_binned",
    "dkl_knn",
]
