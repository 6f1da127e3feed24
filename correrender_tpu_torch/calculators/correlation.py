"""Correlation fields: every voxel's member series against a reference.

Counterpart of ``correrender_tpu/calculators/correlation.py``
(``correlate_field``), Pearson branch. The JAX version flattens large
stacks in 1 GiB Z-slabs because a TPU reshape retiles and copies; in
PyTorch ``stack.reshape(-1, n)`` of a contiguous stack is a view, so the
stack goes to the kernel whole.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.cuda.pearson_kernel import pearson_cuda
from correrender_tpu_torch.ops.registry import measure_from_id, require_ported


def correlate_field(stack: torch.Tensor, ref: torch.Tensor,
                    measure="pearson") -> torch.Tensor:
    """Correlate every voxel's member series against one reference series.

    Args:
      stack: ``(Z, Y, X, n)`` float32 member stack (member axis last).
      ref: ``(n,)`` reference series on the stack's device.
      measure: measure id or enum (Pearson only so far).

    Returns:
      ``(Z, Y, X)`` float32 correlation field.
    """
    m = measure_from_id(measure)
    require_ported(m)
    if ref.dim() != 1:
        raise NotImplementedError(
            "per-voxel reference series (SEPARATE_SYMMETRIC mode) are not "
            "ported yet (ROADMAP A.11)")
    n = stack.shape[-1]
    return _correlate_field_flat(stack.reshape(-1, n), ref).reshape(
        stack.shape[:-1])


def _correlate_field_flat(series: torch.Tensor,
                          ref: torch.Tensor) -> torch.Tensor:
    """Flat-series core of :func:`correlate_field`: (V, n) → (V,). Only
    Pearson reaches it (the others raised in :func:`correlate_field`)."""
    return pearson_cuda(series, ref)
