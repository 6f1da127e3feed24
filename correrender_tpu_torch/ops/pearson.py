"""Pearson product-moment correlation over the member axis.

Semantics follow the reference's one-pass form ``computePearson1``
(reference: src/Calculators/Correlation.cpp:42-99):

    r = (n·Σxy − Σx·Σy) / sqrt((n·Σxx − (Σx)²) · (n·Σyy − (Σy)²))

A zero-variance series gives 0/0 = NaN, as in the reference. ``dtype``
selects the accumulator dtype (float32 or float64).
"""

from __future__ import annotations

import torch


def pearson(x: torch.Tensor, y: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pearson r between ``x`` and ``y`` along the last axis.

    Args:
      x: ``(..., n)`` sample values (e.g. the reference-point series).
      y: ``(..., n)`` sample values (e.g. per-voxel member series).
        Leading axes broadcast.
      dtype: accumulator dtype.

    Returns:
      ``(...)`` correlation coefficients in float32.
    """
    n = x.shape[-1]
    xa = x.to(dtype)
    ya = y.to(dtype)
    return pearson_from_sums(
        n,
        xa.sum(-1),
        ya.sum(-1),
        (xa * ya).sum(-1),
        (xa * xa).sum(-1),
        (ya * ya).sum(-1),
    )


def pearson_moments(y: torch.Tensor, dtype: torch.dtype = torch.float32):
    """Partial moments ``(Σy, Σyy)`` of ``y`` for distributed Pearson
    accumulation (partials from several shards add up)."""
    ya = y.to(dtype)
    return ya.sum(-1), (ya * ya).sum(-1)


def pearson_from_sums(n, sum_x, sum_y, sum_xy, sum_xx, sum_yy):
    """Assemble Pearson r from (possibly all-reduced) raw sums."""
    num = n * sum_xy - sum_x * sum_y
    den = torch.sqrt((n * sum_xx - sum_x * sum_x)
                     * (n * sum_yy - sum_y * sum_y))
    return (num / den).to(torch.float32)


def pearson_from_moments(sum_y: torch.Tensor, sum_yy: torch.Tensor,
                         sum_xy: torch.Tensor,
                         ref: torch.Tensor) -> torch.Tensor:
    """Pearson r from streamed per-voxel moments and the full ``(n,)``
    reference series, in float32: the JAX repo's ``bench.py`` assemble
    step (Σx and Σx² summed from ``ref``, then :func:`pearson_from_sums`'s
    formula in the same operation order)."""
    return pearson_from_sums(ref.shape[0], ref.sum(), sum_y, sum_xy,
                             (ref * ref).sum(), sum_yy)
