"""Correlation fields: every voxel's member series against a reference.

Counterpart of ``correrender_tpu/calculators/correlation.py``
(``correlate_field``). Each measure against one reference series takes
its kernel route, as the JAX package's TPU branches do (:234-296), the
wrapper choosing by the tensor's device (a CPU tensor runs the plain
version): Pearson → K1, Spearman → B7, Kendall → B8, the Kraskov
measures → B10. The binned-MI measures have no kernel in either package
and take the voxel-chunked torch path under the same memory budget.

The JAX version flattens large stacks in 1 GiB Z-slabs because a TPU
reshape retiles and copies; in PyTorch ``stack.reshape(-1, n)`` of a
contiguous stack is a view, so the stack goes to the kernels whole.
The ``CorrelationCalculator`` class is not ported yet (ROADMAP A.3).
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.cuda.kendall_kernel import kendall_cuda
from correrender_tpu_torch.ops.cuda.ksg_banded import mi_ksg_banded
from correrender_tpu_torch.ops.cuda.moments_kernel import chunk_moments_flat
from correrender_tpu_torch.ops.cuda.pearson_kernel import pearson_cuda
from correrender_tpu_torch.ops.cuda.spearman_kernel import spearman_cuda
from correrender_tpu_torch.ops.mi_ksg import kmi_correlation_coefficient
from correrender_tpu_torch.ops.pearson import pearson_from_moments
from correrender_tpu_torch.ops.registry import (
    CorrelationMeasure,
    correlate,
    is_measure_binned_mi,
    is_measure_kraskov_mi,
    measure_from_id,
)

#: Voxel-chunk memory budget of the binned-MI path.
DEFAULT_CHUNK_BUDGET_BYTES = 256 << 20


def _auto_chunk(n: int, budget: int, num_bins: int = 80) -> int:
    """A voxel chunk of the binned-MI measures whose one-hot working set
    fits the budget (the JAX package's size, without its lane
    alignment)."""
    per_voxel = 4 * n * num_bins * 2 + 4 * num_bins * num_bins
    return int(max(budget // per_voxel, 1))


def _correlate_chunked(series: torch.Tensor, ref: torch.Tensor,
                       measure: CorrelationMeasure, voxel_chunk: int,
                       **kwargs) -> torch.Tensor:
    """:func:`ops.correlate` of ``(V, n)`` series against ``ref``, in
    voxel chunks."""
    return torch.cat([
        correlate(ref, series[s:s + voxel_chunk], measure, **kwargs)
        for s in range(0, series.shape[0], voxel_chunk)
    ]) if series.shape[0] else torch.empty(0, device=series.device)


def _nan_bounds(t: torch.Tensor, chunk: int = 1 << 26):
    """(nanmin, nanmax) of ``t`` as 0-d tensors, over chunks of the
    flattened tensor (no full-size temporary)."""
    flat = t.reshape(-1)
    lo, hi = [], []
    for s in range(0, flat.numel(), chunk):
        part = flat[s:s + chunk]
        nan = torch.isnan(part)
        lo.append(torch.where(nan, torch.inf, part).amin())
        hi.append(torch.where(nan, -torch.inf, part).amax())
    return torch.stack(lo).amin(), torch.stack(hi).amax()


def correlate_field(
    stack: torch.Tensor,
    ref: torch.Tensor,
    measure="pearson",
    *,
    num_bins: int = 80,
    k: int = 3,
    kraskov_estimator: int = 1,
    absolute: bool = False,
    mi_bounds=None,
    chunk_budget_bytes: int = DEFAULT_CHUNK_BUDGET_BYTES,
) -> torch.Tensor:
    """Correlate every voxel's member series against one reference series.

    Args:
      stack: ``(Z, Y, X, n)`` float32 member stack (member axis last).
      ref: ``(n,)`` reference series on the stack's device.
      measure: measure id or enum.
      num_bins, k, kraskov_estimator: the binned-MI bins, and KSG's
        neighbour count and estimator.
      absolute: return |value|.
      mi_bounds: global ``(min, max)`` normalization bounds for binned
        MI; by default the global ranges of the reference series and of
        the stack (NaN ignored), as the reference normalizes by the
        global field range (CorrelationCalculator.cpp:820-845).
      chunk_budget_bytes: working-set budget of the binned-MI path.

    Returns:
      ``(Z, Y, X)`` float32 correlation field.
    """
    m = measure_from_id(measure)
    if ref.dim() != 1:
        raise NotImplementedError(
            "per-voxel reference series (SEPARATE_SYMMETRIC mode) are not "
            "ported yet (ROADMAP A.11)")
    if is_measure_binned_mi(m) and mi_bounds is None:
        mi_bounds = (_nan_bounds(ref), _nan_bounds(stack))
    n = stack.shape[-1]
    out = _correlate_field_flat(
        stack.reshape(-1, n), ref, m, num_bins=num_bins, k=k,
        kraskov_estimator=kraskov_estimator, mi_bounds=mi_bounds,
        chunk_budget_bytes=chunk_budget_bytes)
    if absolute:
        out = out.abs()
    return out.reshape(stack.shape[:-1])


def _correlate_field_flat(series: torch.Tensor, ref: torch.Tensor,
                          m: CorrelationMeasure, *, num_bins: int, k: int,
                          kraskov_estimator: int, mi_bounds,
                          chunk_budget_bytes: int) -> torch.Tensor:
    """Flat-series core of :func:`correlate_field`: (V, n) → (V,)."""
    if m == CorrelationMeasure.PEARSON:
        return pearson_cuda(series, ref)
    if m == CorrelationMeasure.SPEARMAN:
        return spearman_cuda(series, ref)
    if m == CorrelationMeasure.KENDALL:
        return kendall_cuda(series, ref)
    if is_measure_kraskov_mi(m):
        out = mi_ksg_banded(series, ref, k=k, estimator=kraskov_estimator)
        if m == CorrelationMeasure.KMI_CORRELATION_COEFFICIENT:
            out = kmi_correlation_coefficient(out)
        return out
    n = series.shape[-1]
    chunk = min(_auto_chunk(n, chunk_budget_bytes, num_bins),
                max(series.shape[0], 1))
    return _correlate_chunked(series, ref, m, chunk, num_bins=num_bins,
                              mi_bounds=mi_bounds)


def pearson_streamed(chunks, ref: torch.Tensor) -> torch.Tensor:
    """Pearson field of a member stack streamed in member chunks.

    The JAX repo's ``bench.py`` streaming loop (``accumulate_onepass``
    over the chunks, then ``assemble``), moved into the library so that
    ``chip_smoke.py`` and a later bench share one implementation: B1 adds
    each chunk's ``(Σy, Σy², Σxy)`` to float32 running sums, and the field
    is assembled once at the end. Nothing waits on the device in between,
    so the chunks' launches queue back to back. A stack too large for the
    card (250³ × 1000 float32 is 62.5 GB) streams through a few resident
    chunk buffers.

    Args:
      chunks: iterable of member-major ``(E_c, Z, Y, X)`` float32 or
        bfloat16 chunks, in member order, on one device.
      ref: ``(n,)`` float32 reference series, ``n = Σ E_c``.

    Returns:
      ``(Z, Y, X)`` float32 Pearson field.
    """
    acc, spatial, seen = None, None, 0
    for chunk in chunks:
        e = chunk.shape[0]
        if acc is None:
            spatial = chunk.shape[1:]
            acc = torch.zeros((3, chunk[0].numel()), dtype=torch.float32,
                              device=chunk.device)
        elif chunk.shape[1:] != spatial:
            raise ValueError(f"chunk {tuple(chunk.shape)} does not match "
                             f"the grid {tuple(spatial)}")
        chunk_moments_flat(chunk.reshape(e, -1), ref[seen:seen + e], acc=acc)
        seen += e
    if acc is None or seen != ref.shape[0]:
        raise ValueError(f"the chunks hold {seen} members, ref {ref.shape[0]}")
    return pearson_from_moments(acc[0], acc[1], acc[2], ref).reshape(spatial)
