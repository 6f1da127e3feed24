"""B8: the Kendall tau-b kernel (``csrc/kendall.cu``) and its plain
version.

Counterpart of ``correrender_tpu/ops/pallas/kendall_kernel.py``, whose
sweep over every ordered pair of members the kernel replaces with
Knight's merge count (the reference's method, Correlation.cpp:305-465).
The reference series is shared by every voxel, so the host orders it
once (:func:`reference_order`: the stable order and each sorted
position's x-tie group); per voxel the kernel gathers y into that
order, sorts it within the x-tie groups, counts the exchanges of a merge
sort of y and reads the y and joint ties off the sorted runs. It writes
the counts the pair sweep gives (Σ sign(Δx)·sign(Δy), the y ties, the
joint ties, over ordered pairs) and a NaN flag; the host counts the x
ties once. Its plain version is :func:`ops.kendall`, whose sweep counts
the same pairs exactly. Both assemble tau in the JAX package's float32
order (:func:`ops.kendall.tau_from_counts`), so kernel and plain version
agree exactly.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.kendall import (
    _accumulator,
    kendall,
    tau_from_counts,
)
from correrender_tpu_torch.ops.ranks import run_bounds, stable_order


def _tie_pairs(x: torch.Tensor) -> torch.Tensor:
    """#{(i, j) : x_i == x_j} over all ordered pairs, the diagonal
    included: Σ c² over the runs of equal sorted values, as
    n + 2·Σ_q (q − first index of q's run), on the device."""
    n = x.shape[0]
    starts, _ = run_bounds(torch.sort(x).values)
    return n + 2 * (torch.arange(n, device=x.device) - starts).sum()


def reference_order(ref: torch.Tensor):
    """``(perm, gstart)``, both ``(n,)`` int32: the stable ascending
    order of the reference and, per sorted position, the first position
    of its run of equal values (its x-tie group)."""
    perm, xs = stable_order(ref)
    starts, _ = run_bounds(xs)
    return perm, starts.to(torch.int32)


def _tau(counts: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """tau from ``(V, 4)`` counts (num, y ties, joint ties, NaN in y)."""
    n = ref.shape[0]
    tau = tau_from_counts(n, counts[:, 0], _tie_pairs(ref), counts[:, 1],
                          counts[:, 2])
    nan = (counts[:, 3] != 0) | torch.isnan(ref).any()
    return torch.where(nan, torch.nan, tau)


def kendall_plain(series: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B8: ``(V, n)`` series against an
    ``(n,)`` reference → ``(V,)`` float32 tau-b, through
    :func:`ops.kendall` over voxel chunks under the memory budget."""
    v, n = series.shape
    _accumulator(n, None)  # raises where the int32 pair counts overflow
    out = torch.empty(v, dtype=torch.float32, device=series.device)
    for sl in _build.voxel_chunks(v, n * 128 * 32):
        out[sl] = kendall(ref, series[sl])
    return out


def kendall_cuda(stack: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Kendall tau-b field of a member-last stack against one reference
    series.

    Args:
      stack: ``(..., n)`` float32 member series, contiguous.
      ref: ``(n,)`` float32 reference series on the same device.

    Returns:
      ``(...)`` float32 tau-b. A CPU tensor takes :func:`kendall_plain`;
      a CUDA tensor launches B8.
    """
    series, lead = _build.member_series("kendall", stack, ref)
    if stack.device.type == "cpu":
        return kendall_plain(series, ref).reshape(lead)
    return _tau(kendall_counts(series, ref), ref).reshape(lead)


def kendall_counts(series: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Launch B8 on ``(V, n)`` CUDA series; returns the ``(V, 4)`` int32
    counts (num, y ties, joint ties, NaN in y)."""
    v, n = series.shape
    counts = torch.empty((v, 4), dtype=torch.int32, device=series.device)
    if v:
        perm, gstart = reference_order(ref)
        lib = _build.library()
        _build.LAUNCHES["kendall"] += 1
        err = lib.correrender_kendall(
            series.data_ptr(), perm.data_ptr(), gstart.data_ptr(),
            counts.data_ptr(), v, n, series.device.index,
            _build.stream_of(series))
        _build.check(err, "kendall")
    return counts
