"""Fractional (tie-averaged) ranking over the member axis.

Counterpart of ``correrender_tpu/ops/ranks.py``. Matches the
reference's ``computeRanks`` (Correlation.cpp:277-303): values are
sorted, every run of equal values gets the mean of the 1-based ranks it
spans. Run starts and ends are marked on the sorted values and each
element's run is recovered with a cumulative max and min.

NaN sorts after every number, and NaNs keep their index order (a stable
sort); a NaN equals nothing, so each is a run of its own. That is what
the JAX package's ``argsort`` path does.
"""

from __future__ import annotations

import torch


def stable_order(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The stable ascending order of an ``(n,)`` series: ``(perm,
    sorted)`` with ``sorted = v[perm]`` and ``perm`` int32, NaN last."""
    sorted_v, perm = torch.sort(v, stable=True)
    return perm.to(torch.int32), sorted_v


def run_bounds(sorted_v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For each position of values sorted along the last axis, the first
    and the last index of its run of equal values (``-0.0 == 0.0``; a
    NaN is a run of its own)."""
    n = sorted_v.shape[-1]
    idx = torch.arange(n, device=sorted_v.device).expand(sorted_v.shape)
    prev_diff = sorted_v[..., 1:] != sorted_v[..., :-1]
    edge = torch.ones(sorted_v.shape[:-1] + (1,), dtype=torch.bool,
                      device=sorted_v.device)
    is_start = torch.cat([edge, prev_diff], dim=-1)
    is_end = torch.cat([prev_diff, edge], dim=-1)
    first = torch.cummax(torch.where(is_start, idx, -1), dim=-1).values
    last = torch.cummin(torch.where(is_end, idx, n).flip(-1),
                        dim=-1).values.flip(-1)
    return first, last


def fractional_ranks(v: torch.Tensor) -> torch.Tensor:
    """1-based fractional ranks along the last axis.

    Args:
      v: ``(..., n)`` values.

    Returns:
      ``(..., n)`` float32 ranks, tie groups averaged.
    """
    sorted_v, order = torch.sort(v, dim=-1, stable=True)
    first, last = run_bounds(sorted_v)
    rank_sorted = (first + last).to(torch.float32) * 0.5 + 1.0
    return torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
