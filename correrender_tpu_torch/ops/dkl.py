"""Kullback–Leibler divergence of the per-voxel member distribution
versus the standard normal.

Counterpart of ``correrender_tpu/ops/dkl.py`` (reference
src/Calculators/DKL.{hpp,cpp}), two estimators:

* **binned**: normalize samples to zero mean / unit variance, histogram
  over [min−0.01, max+0.01], then
  ``Σ p log( p·binFactor / N(center; 0, 1) )`` (DKL.cpp:39-86);
* **k-NN (Kozachenko–Leonenko)**: entropy estimate
  ``H = ⟨log d_k⟩ + ψ(n) − ψ(k) + log 2`` on the 1D samples, then
  ``DKL = −H + ½·log(2π) + ½·⟨v²⟩`` (DKL.cpp:133-169), clamped ≥ 0.

The JAX package histograms by a one-hot sum (``V × n × bins`` floats)
and finds the k-th neighbour distance by ``top_k`` over ``(V, n, n)``
pairwise distances. Here the histogram is a ``scatter_add_`` over
``(voxel, bin)``, and the k-th distance comes from the sorted series: a
point's k nearest neighbours lie among the k points on each side of it
in sorted order, and the distances are the same ``|v_i − v_j|`` floats,
so ``d_k`` is the same value, ties included.
"""

from __future__ import annotations

import math

import torch

from correrender_tpu_torch.ops.special import digamma_series

_TWO_PI = 2.0 * math.pi


def _normalize(v: torch.Tensor) -> torch.Tensor:
    mean = v.mean(-1, keepdim=True)
    var = ((mean - v) ** 2).mean(-1, keepdim=True)
    return (v - mean) / torch.sqrt(var)


def _log_two_pi(like: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.tensor(_TWO_PI, dtype=torch.float32,
                                  device=like.device))


def _finite_or_nan(dkl: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isinf(dkl), torch.nan, dkl).to(torch.float32)


def dkl_binned(v: torch.Tensor, num_bins: int = 80) -> torch.Tensor:
    """Binned KL divergence vs N(0, 1) along the last axis.

    A sample's bin is ``(v − vmin)·b/(vmax − vmin)`` truncated to an
    integer and clamped to ``[0, b − 1]``; a series holding a NaN gives
    NaN."""
    n = v.shape[-1]
    b = num_bins
    vn = _normalize(v.to(torch.float32))
    vmin = vn.amin(-1, keepdim=True) - 0.01
    vmax = vn.amax(-1, keepdim=True) + 0.01
    bin_factor = b / (vmax - vmin)
    bin_width = (vmax - vmin) / b
    # NaN samples are zeroed before the integer cast (whose NaN result
    # differs between devices); their series is NaN either way.
    pos = torch.nan_to_num((vn - vmin) * bin_factor, nan=0.0)
    bins = torch.clamp(pos.to(torch.int32), 0, b - 1).to(torch.int64)
    hist = torch.zeros(vn.shape[:-1] + (b,), dtype=torch.float32,
                       device=vn.device)
    hist.scatter_add_(-1, bins, torch.ones_like(vn))
    p = hist / n
    centers = ((torch.arange(b, dtype=torch.float32, device=vn.device) + 0.5)
               * bin_width + vmin)
    log_q = -0.5 * _log_two_pi(vn) - 0.5 * centers * centers
    log_p_density = torch.log(torch.clamp_min(p, 1e-30) * bin_factor)
    terms = torch.where(hist > 0, p * (log_p_density - log_q), 0.0)
    return _finite_or_nan(terms.sum(-1))


def kth_neighbour_distance(sorted_v: torch.Tensor, k: int) -> torch.Tensor:
    """The distance from each value of an ascending ``(..., n)`` series
    to its k-th nearest other value, at the value's sorted position.

    With ``L_a = s_i − s_{i−a}`` and ``R_b = s_{i+b} − s_i`` (+inf past
    either end), both ascending in a and b, the k-th smallest of the
    union is ``min over a + b = k of max(L_a, R_b)`` (``L_0 = R_0 =
    −inf``), and no point farther than k places away can be nearer."""
    n = sorted_v.shape[-1]
    inf = torch.full(sorted_v.shape[:-1] + (min(k, n),), torch.inf,
                     dtype=sorted_v.dtype, device=sorted_v.device)

    def left(a):
        if a >= n:
            return inf[..., :1].expand_as(sorted_v)
        return torch.cat([inf[..., :a], sorted_v[..., a:]
                          - sorted_v[..., :-a]], -1)

    def right(b):
        if b >= n:
            return inf[..., :1].expand_as(sorted_v)
        return torch.cat([sorted_v[..., b:] - sorted_v[..., :-b],
                          inf[..., :b]], -1)

    dk = None
    for a in range(k + 1):
        if a == 0:
            cand = right(k)
        elif a == k:
            cand = left(k)
        else:
            cand = torch.maximum(left(a), right(k - a))
        dk = cand if dk is None else torch.minimum(dk, cand)
    return dk


def dkl_knn(v: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Kozachenko–Leonenko entropy-based KL divergence vs N(0, 1).

    Exactly tied samples make the k-NN distance 0 and the estimate NaN,
    as in the reference (DKL.cpp:133-166 takes ``log(nnDist)`` unguarded
    and maps the resulting inf to NaN) and the JAX package."""
    n = v.shape[-1]
    vn = _normalize(v.to(torch.float32))
    dk = kth_neighbour_distance(torch.sort(vn, dim=-1).values, k)
    psi = digamma_series(torch.tensor([float(n), float(k)],
                                      dtype=torch.float32, device=vn.device))
    entropy = (torch.log(dk).mean(-1) + psi[0] - psi[1]
               + math.log(2.0))
    second_moment = (vn * vn).mean(-1)
    dkl = -entropy + 0.5 * _log_two_pi(vn) + 0.5 * second_moment
    dkl = torch.where(dkl < 0.0, 0.0, dkl)  # NaN stays NaN
    return _finite_or_nan(dkl)
