"""B9: the full-row KSG kernel (``csrc/ksg.cu``) and its plain version.

Counterpart of ``correrender_tpu/ops/pallas/ksg_kernel.py``. The kernel
finds each point's (k+1)-th smallest Chebyshev distance (self and ties
included) over its whole row, counts the marginals over ``[v − r,
v + r)``, and sums the ψ terms per voxel, as
:func:`ops.mi_ksg.ksg_psi_sums` does in torch (the plain version); the
wrapper adds ψ(k) + ψ(n) (− 1/k) and clamps at 0. The tie-break noise
is added inside the kernel from the ``(n,)`` noise vectors, each sum
rounded once, as the plain version adds it. The wrapper sorts the noised
reference once (:func:`ops.ranks.stable_order`); the kernel scans the
rows in that order and counts the marginals by binary search in the
sorted reference and in a sorted copy of each voxel's y.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.mi_ksg import ksg_mi, ksg_psi_sums
from correrender_tpu_torch.ops.noise import scaled_noise
from correrender_tpu_torch.ops.ranks import stable_order

#: The longest neighbour list a kernel thread keeps (ksg_common.cuh).
MAX_NEIGHBOURS = 16


def check_ksg_args(n: int, k: int, estimator: int, device) -> None:
    if estimator not in (1, 2):
        raise ValueError(f"estimator must be 1 or 2, got {estimator}")
    if not 1 <= k < n:
        raise ValueError(f"k={k} needs 1 ≤ k < n = {n}")
    if torch.device(device).type == "cuda" and k + 1 > MAX_NEIGHBOURS:
        raise ValueError(f"k={k}: the kernels keep at most "
                         f"{MAX_NEIGHBOURS} neighbours (k ≤ "
                         f"{MAX_NEIGHBOURS - 1})")
    _build.check_members("mi_ksg", n, device)


def noised_reference(ref: torch.Tensor, use_noise: bool, noise=None):
    """``(x + nx·1e-5, ny·1e-5)``: the noised reference series and the
    amounts the kernels add to the voxel series (None without noise)."""
    if not use_noise:
        return ref, None
    sx, sy = scaled_noise(ref.shape[0], ref.device, noise)
    return ref + sx, sy


def sorted_reference(ref: torch.Tensor, use_noise: bool, noise=None):
    """``(perm, xs, y_noise)``: the stable ascending order of the noised
    reference, the sorted values, and the amounts the kernels add to the
    voxel series (see :func:`noised_reference`)."""
    x, y_noise = noised_reference(ref, use_noise, noise)
    perm, xs = stable_order(x)
    return perm, xs, y_noise


def mi_from_psi(psi_sum: torch.Tensor, ref: torch.Tensor, k: int,
                estimator: int) -> torch.Tensor:
    """:func:`ops.mi_ksg.ksg_mi` of the kernels' ψ sums; NaN where the
    reference series holds a NaN."""
    mi = ksg_mi(psi_sum, ref.shape[0], k, estimator)
    return torch.where(torch.isnan(ref).any(), torch.nan, mi)


def mi_ksg_plain(series: torch.Tensor, ref: torch.Tensor, k: int = 3,
                 estimator: int = 1, use_noise: bool = True, noise=None,
                 with_counts: bool = False):
    """Plain PyTorch version of B9: ``(V, n)`` series against an
    ``(n,)`` reference → ``(V,)`` float32 MI, through
    :func:`ops.mi_ksg.ksg_psi_sums` over voxel chunks under the memory
    budget; with ``with_counts`` also the per-point ``(V, n, 2)``
    marginal counts."""
    v, n = series.shape
    check_ksg_args(n, k, estimator, "cpu")
    x, y_noise = noised_reference(ref, use_noise, noise)
    psi = torch.empty(v, dtype=torch.float32, device=series.device)
    counts = (torch.empty((v, n, 2), dtype=torch.int32,
                          device=series.device) if with_counts else None)
    for sl in _build.voxel_chunks(v, n * n * 16):
        y = series[sl]
        if y_noise is not None:
            y = y + y_noise
        psi[sl], part = ksg_psi_sums(x, y, k, estimator, with_counts)
        if with_counts:
            counts[sl] = part
    mi = mi_from_psi(psi, ref, k, estimator)
    return (mi, counts) if with_counts else mi


def mi_ksg_cuda(stack: torch.Tensor, ref: torch.Tensor, k: int = 3,
                estimator: int = 1, use_noise: bool = True, noise=None,
                with_counts: bool = False):
    """KSG MI field of a member-last stack against one reference series
    over the full pairwise rows.

    Args:
      stack: ``(..., n)`` float32 member series, contiguous.
      ref: ``(n,)`` float32 reference series on the same device.
      k, estimator: KSG's neighbour count and estimator (1 or 2).
      use_noise, noise: the tie-break noise (by default the JAX
        package's draw; ``noise=(nx, ny)`` for a caller's own).
      with_counts: also return the per-point ``(..., n, 2)`` counts.

    Returns:
      ``(...)`` float32 MI. A CPU tensor takes :func:`mi_ksg_plain`; a
      CUDA tensor launches B9.
    """
    series, lead = _build.member_series("mi_ksg", stack, ref)
    v, n = series.shape
    check_ksg_args(n, k, estimator, stack.device)
    if stack.device.type == "cpu":
        out = mi_ksg_plain(series, ref, k, estimator, use_noise, noise,
                           with_counts)
    else:
        perm, xs, y_noise = sorted_reference(ref, use_noise, noise)
        psi = torch.empty(v, dtype=torch.float32, device=stack.device)
        counts = (torch.empty((v, n, 2), dtype=torch.int32,
                              device=stack.device) if with_counts else None)
        if v:
            lib = _build.library()
            _build.LAUNCHES["mi_ksg"] += 1
            err = lib.correrender_mi_ksg(
                series.data_ptr(), perm.data_ptr(), xs.data_ptr(),
                y_noise.data_ptr() if y_noise is not None else None,
                psi.data_ptr(), counts.data_ptr() if with_counts else None,
                v, n, k, estimator, stack.device.index,
                _build.stream_of(stack))
            _build.check(err, "mi_ksg")
        mi = mi_from_psi(psi, ref, k, estimator)
        out = (mi, counts) if with_counts else mi
    if with_counts:
        return out[0].reshape(lead), out[1].reshape(lead + (n, 2))
    return out.reshape(lead)
