"""Field histograms and min/max reductions for the TF editor.

Counterpart of ``correrender_tpu/utils/histogram.py`` (the reference's
src/Volume/Histogram.{hpp,cpp}: min/max, histogram, divide by the
largest bin, and the sign-symmetric min/max of signed fields). Plain
torch on the field's device.

Torch has no ``nanmin``/``nanmax``: NaN is masked to +inf (-inf) before
``amin`` (``amax``), and an all-NaN field gives NaN as ``jnp.nanmin``
does. Bins are counted exactly in int64 (``torch.bincount``), where JAX
adds float32 ones and stops counting at 2^24 in one bin; below that the
normalized counts equal JAX's.
"""

from __future__ import annotations

import torch


def nanmin(x: torch.Tensor) -> torch.Tensor:
    """NaN-ignoring minimum (a 0-dim tensor); NaN if every value is."""
    nan = torch.isnan(x)
    m = torch.where(nan, torch.inf, x).amin()
    return torch.where(nan.all(), torch.nan, m)


def nanmax(x: torch.Tensor) -> torch.Tensor:
    """NaN-ignoring maximum (a 0-dim tensor); NaN if every value is."""
    nan = torch.isnan(x)
    m = torch.where(nan, -torch.inf, x).amax()
    return torch.where(nan.all(), torch.nan, m)


def min_max(field: torch.Tensor):
    """NaN-ignoring ``(min, max)`` of a field, 0-dim tensors."""
    return nanmin(field), nanmax(field)


def divergent_min_max(field: torch.Tensor):
    """Sign-symmetric range ``(−m, m)`` with ``m = max|field|``: signed
    fields (correlations) centre their TF at zero."""
    m = nanmax(field.abs())
    return -m, m


def histogram(field: torch.Tensor, num_bins: int = 256, bounds=None,
              normalize: bool = True):
    """Histogram of the finite values of a field.

    Returns ``(counts, (lo, hi))``: the NaN-ignoring range, or
    ``bounds`` in float32, as 0-dim tensors. With
    ``normalize`` the counts are float32 divided by the largest bin (the
    reference's ComputeHistogramDividePass); without it they are the
    exact int64 counts.
    """
    flat = field.reshape(-1)
    ok = torch.isfinite(flat)
    if bounds is None:
        lo, hi = nanmin(flat), nanmax(flat)
    else:
        lo, hi = (torch.tensor(float(b), dtype=torch.float32,
                               device=flat.device) for b in bounds)
    # (v − lo) / max(hi − lo, 1e-30) by a device tensor: a Python divisor
    # becomes a reciprocal product on CUDA, which moves bin edges.
    u = (flat[ok] - lo) / torch.clamp_min(hi - lo, 1e-30)
    # XLA converts a NaN position (an infinite range) to bin 0.
    bins = torch.clamp(torch.nan_to_num(u * num_bins, nan=0.0), 0,
                       num_bins - 1).to(torch.int64)
    counts = torch.bincount(bins, minlength=num_bins)
    if normalize:
        counts = counts.to(torch.float32)
        counts = counts / torch.clamp_min(counts.max(), 1.0)
    return counts, (lo, hi)
