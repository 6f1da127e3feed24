"""Spearman rank correlation: Pearson on fractional ranks.

Counterpart of ``correrender_tpu/ops/spearman.py`` (reference:
CorrelationCalculator.cpp:900-940). A caller that ranked the reference
series once passes ``x_is_ranked=True``.

A fractional rank r is a multiple of 1/2, so the moments of the doubled
ranks 2r are integers: they are summed exactly in int64, and rho is
assembled from them in float64 (:func:`rho_from_moments`). The JAX
package sums the ranks in float32, about 1e-7 of rounding at n = 1000.
Kernel B7 computes the same integer sums, and its wrapper assembles rho
with the same function.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.ranks import fractional_ranks


def doubled_ranks(v: torch.Tensor, is_ranked: bool = False) -> torch.Tensor:
    """``2 · fractional_ranks(v)`` as exact int64 (``v`` itself holds
    fractional ranks if ``is_ranked``)."""
    r = v if is_ranked else fractional_ranks(v)
    return torch.round(r * 2.0).to(torch.int64)


def rho_from_moments(n: int, s_x, s_xx, s_y, s_yy, s_xy) -> torch.Tensor:
    """float32 rho from the int64 sums Σa, Σa², Σb, Σb², Σab of two
    doubled-rank series: the numerator and both variances exact in int64,
    the quotient in float64. ``s_x``, ``s_xx`` and ``s_y`` may be Python
    ints or 0-d tensors (a per-voxel tensor of ``s_y`` broadcasts)."""
    num = torch.add(-(s_x * s_y), s_xy, alpha=n)
    var_x = n * s_xx - s_x * s_x
    var_y = torch.add(-(s_y * s_y), s_yy, alpha=n)
    rho = num.to(torch.float64) / torch.sqrt(
        var_x.to(torch.float64) * var_y.to(torch.float64))
    return rho.to(torch.float32)


def spearman(x: torch.Tensor, y: torch.Tensor, *,
             x_is_ranked: bool = False,
             y_is_ranked: bool = False) -> torch.Tensor:
    """Spearman rho between ``x`` and ``y`` along the last axis (leading
    axes broadcast), in float32. The JAX package's ``dtype`` (its
    accumulator) has no counterpart: the rank sums are exact integers."""
    rx = doubled_ranks(x, x_is_ranked)
    ry = doubled_ranks(y, y_is_ranked)
    return rho_from_moments(rx.shape[-1], rx.sum(-1), (rx * rx).sum(-1),
                            ry.sum(-1), (ry * ry).sum(-1), (rx * ry).sum(-1))
