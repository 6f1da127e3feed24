"""Whole-field similarity between two scalar fields.

Counterpart of ``correrender_tpu/ops/similarity.py`` (reference
src/Calculators/Similarity.cpp:36-188): the voxels of two fields
(optionally of all members) are flattened into one long sample series
each and any correlation measure is evaluated on the pair; it drives the
"Compute Field Similarity" dialog (MainApp.hpp:181-186).
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.ops.registry import (
    CorrelationMeasure,
    correlate,
    is_measure_kraskov_mi,
    measure_from_id,
)


def field_similarity(
    field_a: torch.Tensor,
    field_b: torch.Tensor,
    measure: str = "pearson",
    max_samples: int = 200_000,
    seed: int = 0,
    **measure_kw,
) -> float:
    """Similarity of two equally-shaped fields under a measure.

    The fields are tensors on one device, where the measure runs (arrays
    are refused: the caller picks the device). NaN positions in either
    field are excluded; above ``max_samples`` finite pairs a subsample
    drawn by numpy's ``default_rng(seed).choice``, the JAX package's
    draw, bounds the O(n²) measures, so both packages pick the same
    points. The subsample is indexed on the fields' device.

    Kendall self-similarity is < 1 on data holding repeated values: the
    reference's forced n3 = 0 (Correlation.cpp:444) gives
    (n0 − 2t)/(n0 − t) for t joint-tied pairs.
    """
    if not (torch.is_tensor(field_a) and torch.is_tensor(field_b)):
        raise TypeError("field_similarity takes tensors; put arrays on "
                        "the device first (torch.as_tensor(x, device=...))")
    if field_a.device != field_b.device:
        raise ValueError(f"the fields lie on {field_a.device} and "
                         f"{field_b.device}")
    a = field_a.to(torch.float32).reshape(-1)
    b = field_b.to(torch.float32).reshape(-1)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    ok = torch.isfinite(a) & torch.isfinite(b)
    a, b = a[ok], b[ok]
    m = measure_from_id(measure)
    if is_measure_kraskov_mi(m):
        # The single-pair KSG path holds (n, n) neighbour rows; the JAX
        # package caps it at 16384 samples, and so does the port.
        max_samples = min(max_samples, 16384)
    if m == CorrelationMeasure.KENDALL and "dtype" not in measure_kw:
        # int32 pair counts are exact up to n = 46340 (ops/kendall.py).
        max_samples = min(max_samples, 46340)
    if a.shape[0] > max_samples:
        idx = np.random.default_rng(seed).choice(
            a.shape[0], max_samples, replace=False)
        idx = torch.as_tensor(idx, device=a.device)
        a, b = a[idx], b[idx]
    return float(correlate(a, b, m, **measure_kw))


def volume_field_similarity(volume_data, name_a, name_b,
                            measure="pearson", all_members=False, **kw):
    """Similarity between two named fields of a VolumeData, optionally
    concatenating all members (Similarity.cpp all-t/e mode)."""
    members = range(volume_data.grid.es) if all_members else [0]
    va = torch.cat([volume_data.get_field(name_a, 0, e).reshape(-1)
                    for e in members])
    vb = torch.cat([volume_data.get_field(name_b, 0, e).reshape(-1)
                    for e in members])
    return field_similarity(va, vb, measure, **kw)
