"""B8: the Kendall tau-b kernel (``csrc/kendall.cu``) and its plain
version.

Counterpart of ``correrender_tpu/ops/pallas/kendall_kernel.py``. The
kernel counts, in integers over all ordered pairs of a voxel's members,
Σ sign(Δx)·sign(Δy), the y ties and the joint ties; the host counts the
x ties once. Its plain version is :func:`ops.kendall`, whose sweep
counts the same pairs exactly. Both assemble tau in the JAX package's
float32 order (:func:`ops.kendall.tau_from_counts`), so kernel and plain
version agree exactly.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.kendall import (
    _accumulator,
    kendall,
    tau_from_counts,
)


def _tie_pairs(x: torch.Tensor) -> torch.Tensor:
    """#{(i, j) : x_i == x_j} over all ordered pairs, the diagonal of
    the non-NaN members included."""
    _, counts = torch.unique_consecutive(torch.sort(x).values,
                                         return_counts=True)
    return (counts.to(torch.int64) ** 2).sum()


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
    v, n = series.shape
    counts = torch.empty((v, 4), dtype=torch.int32, device=stack.device)
    if v:
        lib = _build.library()
        _build.LAUNCHES["kendall"] += 1
        err = lib.correrender_kendall(
            series.data_ptr(), ref.data_ptr(), counts.data_ptr(), v, n,
            stack.device.index, _build.stream_of(stack))
        _build.check(err, "kendall")
    return _tau(counts, ref).reshape(lead)
