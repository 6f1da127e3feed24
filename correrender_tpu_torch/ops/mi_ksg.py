"""Kraskov–Stögbauer–Grassberger (KSG) k-NN mutual information.

Counterpart of ``correrender_tpu/ops/mi_ksg.py`` (reference
``computeMutualInformationKraskov{,2}``, MutualInformation.cpp:399-509;
Kraskov et al., Phys. Rev. E 69, 066138, 2004):

* uniform tie-break noise of amplitude 1e-5 on each axis, the JAX
  package's draw bit for bit (:mod:`ops.noise`), or a caller's own;
* the k-th nearest neighbour in the joint space under the Chebyshev
  metric, among k+1 neighbours that include the point itself;
* per-axis counts over the half-open ``[v − r, v + r)`` of the
  reference's binary searches, with the ±1e-6 epsilon;
* estimator 1: MI = −⟨ψ(nx+1)⟩ − ⟨ψ(ny+1)⟩ + ψ(k) + ψ(n);
  estimator 2: MI = −⟨ψ(nx)⟩ − ⟨ψ(ny)⟩ + ψ(k) − 1/k + ψ(n);
  both clamped to ≥ 0; ψ is the series of :mod:`ops.special`, which
  the KSG kernels B9 and B10 evaluate too (this is their plain version).

A series holding a NaN gives NaN. (The JAX package's three KSG paths
give three different finite values there.)
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.noise import COUNT_EPSILON, scaled_noise
from correrender_tpu_torch.ops.special import digamma_series, select_kth


def add_noise(x: torch.Tensor, y: torch.Tensor, noise=None):
    """``(x + nx·1e-5, y + ny·1e-5)`` in float32, each product and sum
    rounded once (see :func:`ops.noise.scaled_noise`)."""
    sx, sy = scaled_noise(x.shape[-1], x.device, noise)
    return x.to(torch.float32) + sx, y.to(torch.float32) + sy


def ksg_constant(k: int, n: int, estimator: int) -> float:
    """ψ(k) + ψ(n), minus 1/k for estimator 2."""
    psi = torch.special.digamma(torch.tensor([float(k), float(n)],
                                             dtype=torch.float64))
    const = float(psi[0] + psi[1])
    return const - 1.0 / k if estimator == 2 else const


def ksg_mi(psi_sum: torch.Tensor, n: int, k: int,
           estimator: int) -> torch.Tensor:
    """MI = max(−Σψ/n + ψ(k) + ψ(n) (− 1/k), 0) from the per-series ψ
    sums; NaN stays NaN."""
    return torch.clamp(-psi_sum / n + ksg_constant(k, n, estimator), min=0.0)


def ksg_psi_sums(x: torch.Tensor, y: torch.Tensor, k: int, estimator: int,
                 with_counts: bool = False):
    """Σ_i ψ(c_x,i) + ψ(c_y,i) per series, from the full pairwise rows.

    ``x`` and ``y`` are the noised ``(..., n)`` float32 series; their
    leading axes broadcast, and a shared ``(n,)`` reference stays one
    row. c is the marginal count over ``[v − r, v + r)``, minus one for
    estimator 2, at least 1; ψ is :func:`ops.special.digamma_series`,
    the series the kernels evaluate. Returns the ``(...)`` sums, NaN
    where a series holds a NaN, and with ``with_counts`` the per-point
    ``(..., n, 2)`` int32 counts (else None).
    """
    dx = (x[..., :, None] - x[..., None, :]).abs()  # (..., n, n)
    dy = (y[..., :, None] - y[..., None, :]).abs()
    d = torch.maximum(dx, dy)
    r = select_kth(d, k)
    if estimator == 1:
        rx = ry = r - COUNT_EPSILON
    else:
        # The tie-inclusive neighbour set: every point at the k-th
        # distance takes part (the JAX package's convention).
        nbr = d <= r[..., None]
        rx = torch.where(nbr, dx, -1.0).amax(-1) + COUNT_EPSILON
        ry = torch.where(nbr, dy, -1.0).amax(-1) + COUNT_EPSILON
        del nbr
    del d, dy
    cx = _range_count(x, rx)
    cy = _range_count(y, ry)
    counts = (torch.stack(torch.broadcast_tensors(cx, cy), -1).to(
        torch.int32) if with_counts else None)
    cx, cy = cx.to(torch.float32), cy.to(torch.float32)
    if estimator == 2:
        cx, cy = cx - 1.0, cy - 1.0
    terms = (digamma_series(torch.clamp(cx, min=1.0))
             + digamma_series(torch.clamp(cy, min=1.0)))
    has_nan = torch.isnan(x).any(-1) | torch.isnan(y).any(-1)
    return torch.where(has_nan, torch.nan, terms.sum(-1)), counts


def mutual_information_kraskov(x: torch.Tensor, y: torch.Tensor, k: int = 3,
                               estimator: int = 1, use_noise: bool = True,
                               noise=None) -> torch.Tensor:
    """KSG mutual information along the last axis.

    Args:
      x, y: ``(..., n)`` sample values; leading axes broadcast.
      k: neighbour count (reference default 3).
      estimator: 1 or 2 (Kraskov's two estimators).
      use_noise: add the tie-break noise.
      noise: optional ``(nx, ny)`` uniforms in place of the default draw.

    Returns:
      ``(...)`` float32 MI in nats, clamped to ≥ 0.
    """
    if estimator not in (1, 2):
        raise ValueError(f"estimator must be 1 or 2, got {estimator}")
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    if use_noise:
        xf, yf = add_noise(xf, yf, noise)
    psi, _ = ksg_psi_sums(xf, yf, k, estimator)
    return ksg_mi(psi, x.shape[-1], k, estimator)


def _range_count(v: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Points of ``v`` in ``[v_i − r_i, v_i + r_i)`` per centre i (the
    half-open interval of the reference's binary searches,
    MutualInformation.cpp:201-233)."""
    lo = v[..., :, None] - radius[..., :, None]
    hi = v[..., :, None] + radius[..., :, None]
    vj = v[..., None, :]
    return ((vj >= lo) & (vj < hi)).sum(-1)


def maximum_mutual_information_kraskov(k: int, n: int) -> float:
    """ψ(n) − ψ(k): the KSG estimator's largest value (reference
    computeMaximumMutualInformationKraskov, MutualInformation.cpp:
    526-528)."""
    psi = torch.special.digamma(torch.tensor([float(n), float(k)],
                                             dtype=torch.float64))
    return float(psi[0] - psi[1])


def kmi_correlation_coefficient(mi: torch.Tensor) -> torch.Tensor:
    """sqrt(1 − exp(−2·MI)) (reference CorrelationCalculator.cpp:
    1130-1131)."""
    return torch.sqrt(torch.clamp(1.0 - torch.exp(-2.0 * mi), min=0.0))
