"""B7: the Spearman kernel (``csrc/spearman.cu``) and its plain version.

Counterpart of ``correrender_tpu/ops/pallas/spearman_kernel.py``. The
kernel ranks each voxel's members by sorting them (the TPU kernel counts
ranks pairwise), takes each member's doubled tie-averaged rank 2r (an
integer) and the moments Σ(2r)² and Σ(2r)(2r_x) in integers against the
doubled reference ranks, and writes Σ2r = n(n + 1), which holds for any
series. Up to 1024 members a lane sorts E = pow2(n) / lanes keys in
registers and the voxel's lanes merge their runs through shared memory:
8 lanes a voxel up to n = 128, 32 lanes above; beyond that, one warp a
voxel sorts in shared memory. Its plain version is :func:`ops.spearman`, which sums the
same integers; both assemble rho with
:func:`ops.spearman.rho_from_moments`, so they agree to the last float32
bit. NaN members rank as in the XLA path ``ops.spearman``: after every
number, in index order.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.ranks import fractional_ranks
from correrender_tpu_torch.ops.spearman import (
    doubled_ranks,
    rho_from_moments,
    spearman,
)


def spearman_plain(series: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B7: ``(V, n)`` series against an
    ``(n,)`` reference → ``(V,)`` float32 rho, over voxel chunks under
    the memory budget."""
    v, n = series.shape
    ranked = fractional_ranks(ref)
    out = torch.empty(v, dtype=torch.float32, device=series.device)
    for sl in _build.voxel_chunks(v, n * 64):
        out[sl] = spearman(ranked, series[sl], x_is_ranked=True)
    return out


def spearman_cuda(stack: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Spearman rho field of a member-last stack against one reference
    series.

    Args:
      stack: ``(..., n)`` float32 member series, contiguous.
      ref: ``(n,)`` float32 reference series on the same device.

    Returns:
      ``(...)`` float32 rho. A CPU tensor takes :func:`spearman_plain`;
      a CUDA tensor launches B7 (the reference's ranks come from
      :func:`fractional_ranks`, once).
    """
    series, lead = _build.member_series("spearman", stack, ref)
    if stack.device.type == "cpu":
        return spearman_plain(series, ref).reshape(lead)
    v, n = series.shape
    xrank2 = doubled_ranks(ref)
    sums = torch.empty((v, 3), dtype=torch.int64, device=stack.device)
    if v:
        xr = xrank2.to(torch.int32)
        lib = _build.library()
        _build.LAUNCHES["spearman"] += 1
        err = lib.correrender_spearman(
            series.data_ptr(), xr.data_ptr(), sums.data_ptr(), v, n,
            stack.device.index, _build.stream_of(stack))
        _build.check(err, "spearman")
    # Column 0 holds Σ2r = n(n + 1) for every voxel; the identity spares
    # the assembly a pass over it.
    return rho_from_moments(n, xrank2.sum(), (xrank2 * xrank2).sum(),
                            n * (n + 1), sums[:, 1],
                            sums[:, 2]).reshape(lead)
