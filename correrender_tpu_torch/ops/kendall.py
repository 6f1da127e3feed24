"""Kendall rank correlation (tau-b) over the member axis.

Counterpart of ``correrender_tpu/ops/kendall.py``. The reference
assembles (Correlation.cpp:305-465)

    tau = (n0 - n1 - n2 - 2·S) / (sqrt(n0-n1) · sqrt(n0-n2))

with n0 = n(n-1)/2, n1 and n2 the tied pairs of x and y, and the joint
ties n3 forced to 0 (``IntType n3 = 0``). The pairwise form

    sum_{i<j} sign(x_i - x_j) · sign(y_i - y_j) = n0 - n1 - n2 + n3 - 2·S

gives the same value once the joint-tie count n3 is subtracted from it.
The sweep runs over all ordered pairs, tiled over the member axis. Its
counts are exact integers, so the same sweep is kernel B8's plain
version (``ops/cuda/kendall_kernel.py``).
"""

from __future__ import annotations

import torch


def _accumulator(n: int, dtype):
    """JAX's rule: float32 while the double-counted sum n(n−1) stays
    below 2²⁴, int32 up to n = 46340, beyond that an explicit dtype."""
    if dtype is not None:
        return dtype
    if n * (n - 1) < 2 ** 24:
        return torch.float32
    if n <= 46340:
        return torch.int32
    raise ValueError(
        f"kendall: n={n} overflows int32 pair counts (n ≤ 46340); pass an "
        "explicit accumulator dtype (e.g. torch.float64)")


def tau_from_counts(n: int, num, tie_x, tie_y, tie_xy) -> torch.Tensor:
    """tau-b from the double-counted pair sums over all ordered pairs
    (the diagonal included in the tie counts), in the JAX package's
    float32 order (``kendall_kernel.py:114-123``)."""
    num = num.to(torch.float32) * 0.5
    n1 = (tie_x.to(torch.float32) - n) * 0.5
    n2 = (tie_y.to(torch.float32) - n) * 0.5
    n3 = (tie_xy.to(torch.float32) - n) * 0.5
    num = num - n3
    n0 = 0.5 * n * (n - 1)
    den = torch.sqrt(n0 - n1) * torch.sqrt(n0 - n2)
    return (num / den).to(torch.float32)


def pair_counts(x: torch.Tensor, y: torch.Tensor, acc: torch.dtype,
                chunk: int = 128):
    """Σ sign(Δx)·sign(Δy), the x ties, the y ties and the joint ties
    over all ordered pairs (the diagonal included), summed in ``acc``
    over member tiles of width ``chunk``. ``x`` and ``y`` broadcast over
    their leading axes; a shared ``(n,)`` series stays one row."""
    n = x.shape[-1]
    num = tie_x = tie_y = tie_xy = torch.zeros((), dtype=acc, device=x.device)
    for start in range(0, n, chunk):
        dx = x[..., :, None] - x[..., None, start:start + chunk]
        dy = y[..., :, None] - y[..., None, start:start + chunk]
        tx = (dx == 0).to(acc)
        ty = (dy == 0).to(acc)
        num = num + (torch.sign(dx).to(acc) * torch.sign(dy).to(acc)).sum(
            (-2, -1), dtype=acc)
        tie_x = tie_x + tx.sum((-2, -1), dtype=acc)
        tie_y = tie_y + ty.sum((-2, -1), dtype=acc)
        tie_xy = tie_xy + (tx * ty).sum((-2, -1), dtype=acc)
    return num, tie_x, tie_y, tie_xy


def kendall(x: torch.Tensor, y: torch.Tensor, dtype=None, *,
            chunk: int = 128) -> torch.Tensor:
    """Kendall tau-b between ``x`` and ``y`` along the last axis.

    Args:
      x, y: ``(..., n)`` values; leading axes broadcast.
      dtype: accumulator dtype of the pair counts (see
        :func:`_accumulator`). The summands are exact signs and
        indicators, so either accumulator is exact in its range.
      chunk: member-axis tile width of the pair sweep.

    Returns:
      ``(...)`` float32 tau-b; NaN where a series holds a NaN.
    """
    n = x.shape[-1]
    tau = tau_from_counts(n, *pair_counts(x, y, _accumulator(n, dtype),
                                          chunk))
    # torch.sign(NaN) is 0 and an integer cast swallows NaN: apply the
    # NaN that JAX's float sums carry (and its integer path re-applies).
    has_nan = torch.isnan(x).any(-1) | torch.isnan(y).any(-1)
    return torch.where(has_nan, torch.nan, tau)
