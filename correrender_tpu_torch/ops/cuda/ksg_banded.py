"""B10: the KSG kernel of the x-ordered scan (``csrc/ksg_banded.cu``)
and its plain version.

Counterpart of ``correrender_tpu/ops/pallas/ksg_banded.py``, whose band
of W ranks around each point in x order, gap check and repair tiers the
kernel replaces with an exact pruned scan. The reference series is
shared by every voxel, so it is sorted once here; per point the kernel
walks outward in that order and stops a side once its |Δx| reaches the
current k-th distance (estimator 2's extents: once |Δx| passes r),
which gives the full row's k-th distance, extents and counts bit for
bit. The result is B9's, point for point. ``w_band`` no longer changes
what the kernel reads: it is checked as the JAX package checks it, and
the ``repaired`` count of ``with_counts`` is, per voxel, the points
whose answer needs a point outside the rank band of W around them (one
with |Δx| < r; for estimator 2's extents |Δx| ≤ r), not the points the
scan happened to read: how often the JAX kernel's band assumption fails
on the data. The JAX kernel repairs a point whenever a band edge's gap
is ≤ r + 1e-6, so it repairs at least these.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.ksg_kernel import (
    check_ksg_args,
    mi_from_psi,
    mi_ksg_plain,
    sorted_reference,
)

#: The default rank-band width (the JAX package's ``w_band``).
W_BAND = 192


def band_width(n: int, k: int, w_band: int = W_BAND) -> int:
    """``w_band`` clamped to n rounded up to 128, as the JAX package
    clamps it; it must hold k+1 neighbours on either side of a point."""
    w = int(min(w_band, -(-n // 128) * 128))
    if k + 1 > w // 2:
        raise ValueError(f"k={k} too large for band width {w}")
    return w


def mi_ksg_banded_plain(series: torch.Tensor, ref: torch.Tensor, k: int = 3,
                        estimator: int = 1, use_noise: bool = True,
                        noise=None, w_band: int = W_BAND,
                        with_counts: bool = False):
    """Plain PyTorch version of B10: the full-row answer (B9's plain
    version), which the kernel's pruned scan gives exactly; ``w_band``
    is checked as the kernel checks it."""
    band_width(series.shape[-1], k, w_band)
    return mi_ksg_plain(series, ref, k, estimator, use_noise, noise,
                        with_counts)


def mi_ksg_banded(stack: torch.Tensor, ref: torch.Tensor, k: int = 3,
                  estimator: int = 1, use_noise: bool = True, noise=None,
                  w_band: int = W_BAND, with_counts: bool = False):
    """KSG MI field of a member-last stack against one reference series,
    by the pruned scan in x order.

    Args:
      stack: ``(..., n)`` float32 member series, contiguous.
      ref: ``(n,)`` float32 reference series on the same device.
      k, estimator: KSG's neighbour count and estimator (1 or 2).
      use_noise, noise: the tie-break noise (see :func:`mi_ksg_cuda`).
      w_band: the JAX package's rank-band width, checked as it checks
        it; the result does not depend on it.
      with_counts: also return ``{"counts": (..., n, 2) int32,
        "repaired": (...) int32}``, the per-point marginal counts and
        the points per voxel whose answer needs a point outside the
        rank band of ``w_band`` (None on the CPU).

    Returns:
      ``(...)`` float32 MI. A CPU tensor takes
      :func:`mi_ksg_banded_plain`; a CUDA tensor launches B10.
    """
    series, lead = _build.member_series("mi_ksg_banded", stack, ref)
    v, n = series.shape
    check_ksg_args(n, k, estimator, stack.device)
    w = band_width(n, k, w_band)
    if stack.device.type == "cpu":
        out = mi_ksg_banded_plain(series, ref, k, estimator, use_noise,
                                  noise, w_band, with_counts)
        if not with_counts:
            return out.reshape(lead)
        return out[0].reshape(lead), {
            "counts": out[1].reshape(lead + (n, 2)), "repaired": None}
    psi, counts, repaired = banded_psi_sums(
        series, ref, k, estimator, use_noise, noise, w, with_counts)
    mi = mi_from_psi(psi, ref, k, estimator).reshape(lead)
    if not with_counts:
        return mi
    return mi, {"counts": counts.reshape(lead + (n, 2)),
                "repaired": repaired.reshape(lead)}


def banded_psi_sums(series: torch.Tensor, ref: torch.Tensor, k: int,
                    estimator: int, use_noise: bool, noise, w: int,
                    with_counts: bool):
    """Launch B10 on ``(V, n)`` CUDA series; returns the ``(V,)`` ψ sums and, with ``with_counts``, the
    ``(V, n, 2)`` counts and ``(V,)`` points that need a point outside
    the band (else None, None)."""
    v, n = series.shape
    perm, xs, y_noise = sorted_reference(ref, use_noise, noise)
    psi = torch.empty(v, dtype=torch.float32, device=series.device)
    counts = repaired = None
    if with_counts:
        counts = torch.empty((v, n, 2), dtype=torch.int32,
                             device=series.device)
        repaired = torch.empty(v, dtype=torch.int32, device=series.device)
    if v:
        lib = _build.library()
        _build.LAUNCHES["mi_ksg_banded"] += 1
        err = lib.correrender_mi_ksg_banded(
            series.data_ptr(), perm.data_ptr(), xs.data_ptr(),
            y_noise.data_ptr() if y_noise is not None else None,
            psi.data_ptr(), counts.data_ptr() if with_counts else None,
            repaired.data_ptr() if with_counts else None, v, n, w, k,
            estimator, series.device.index,
            _build.stream_of(series))
        _build.check(err, "mi_ksg_banded")
    return psi, counts, repaired
