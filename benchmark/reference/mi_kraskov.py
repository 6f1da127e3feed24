"""Kraskov–Stögbauer–Grassberger mutual information, plain, per voxel.

The definition the reference application computes
(MutualInformation.cpp, ``computeMutualInformationKraskov{,2}``;
Kraskov et al., Phys. Rev. E 69, 066138, 2004), written out over the
full pairwise rows of each voxel:

* tie-break noise: ``x + u_x·1e-5`` and ``y + u_y·1e-5`` in float32,
  each product and sum rounded once, where ``u_x`` and ``u_y`` are the
  ``(n,)`` uniforms of the Threefry-2x32 counter generator under two
  fixed seeds (:func:`threefry_uniform`), the same vector for every
  voxel;
* r: the (k+1)-th smallest Chebyshev distance of a point's row, the
  point itself and ties included;
* per-axis counts over ``[v − r', v + r')`` with ``r' = r − 1e-6``
  (estimator 1), or, for estimator 2, with r' the largest per-axis
  distance among the points within r, plus 1e-6; the bounds rounded to
  float32, each count the number of values below the upper bound less
  the number below the lower, by binary search in a sorted copy (the
  same count as the pairwise comparisons, in n·log n);
* estimator 1: MI = −⟨ψ(nx+1)⟩ − ⟨ψ(ny+1)⟩ + ψ(k) + ψ(n) with counts
  that include the point; estimator 2 takes the counts minus one and
  subtracts 1/k; both clamped at 0. ψ of the integer counts in float64.
"""

from __future__ import annotations

import numpy as np
import torch

NOISE_AMPLITUDE = 1e-5
COUNT_EPSILON = 1e-6
#: Seeds of the reference-series and the voxel-series noise.
SEED_X = 617406168
SEED_Y = 864730169
#: float32 elements of one voxel block's distance matrix (256 MiB).
BLOCK_ELEMENTS = 1 << 26

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry_uniform(seed: int, n: int) -> np.ndarray:
    """``(n,)`` float32 uniforms in [0, 1): Threefry-2x32 (20 rounds) of
    the counters ``(0, i)`` under the key ``(0, seed)``; the two output
    words XORed, their top 23 bits as a mantissa."""
    k0, k1 = np.uint32(0), np.uint32(seed)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.zeros(n, np.uint32) + ks[0]
    x1 = np.arange(n, dtype=np.uint32) + ks[1]
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(group + 1) % 3]
        x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    bits = x0 ^ x1
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)


def _noise(n: int, device):
    return tuple(torch.as_tensor(threefry_uniform(s, n), device=device)
                 * NOISE_AMPLITUDE for s in (SEED_X, SEED_Y))


def _counts(ordered: torch.Tensor, v: torch.Tensor,
            radius: torch.Tensor) -> torch.Tensor:
    """``#{j: v_i − r_i <= u_j < v_i + r_i}`` over the values ``u`` sorted
    in ``ordered`` (``(n,)`` or one row per row of ``v``)."""
    below_hi = torch.searchsorted(ordered, v + radius)
    below_lo = torch.searchsorted(ordered, v - radius)
    return (below_hi - below_lo).clamp_min(0)


def _psi_sums(x: torch.Tensor, x_sorted: torch.Tensor, dx: torch.Tensor,
              y: torch.Tensor, k: int, estimator: int) -> torch.Tensor:
    """float64 Σ_i ψ(c_x,i) + ψ(c_y,i) of ``(B, n)`` noised series ``y``
    against the ``(n,)`` noised reference ``x`` (``dx`` its pairwise
    distances)."""
    dy = (y[:, :, None] - y[:, None, :]).abs()
    d = torch.maximum(dx, dy)
    r = torch.topk(d, k + 1, dim=-1, largest=False).values[..., k]
    if estimator == 1:
        rx = ry = r - COUNT_EPSILON
    else:
        within = d <= r[..., None]
        rx = torch.where(within, dx, -1.0).amax(-1) + COUNT_EPSILON
        ry = torch.where(within, dy, -1.0).amax(-1) + COUNT_EPSILON
        del within
    del d, dy
    cx = _counts(x_sorted, x.expand_as(rx), rx).to(torch.float64)
    cy = _counts(torch.sort(y, dim=-1).values, y, ry).to(torch.float64)
    if estimator == 2:
        cx, cy = cx - 1.0, cy - 1.0
    psi = (torch.special.digamma(torch.clamp(cx, min=1.0))
           + torch.special.digamma(torch.clamp(cy, min=1.0)))
    return psi.sum(-1)


def ksg_mi(series: torch.Tensor, ref: torch.Tensor, k: int = 3,
           estimator: int = 1) -> torch.Tensor:
    """``(V,)`` float64 KSG MI of ``(V, n)`` float32 series (anything
    sliced by rows to ``(B, n)``, with ``shape`` and ``device``) against
    the ``(n,)`` float32 reference series."""
    if estimator not in (1, 2):
        raise ValueError(f"estimator must be 1 or 2, got {estimator}")
    n = series.shape[1]
    sx, sy = _noise(n, series.device)
    x = ref.to(torch.float32) + sx
    x_sorted = torch.sort(x).values
    dx = (x[:, None] - x[None, :]).abs()
    out = torch.empty(series.shape[0], dtype=torch.float64,
                      device=series.device)
    step = max(1, BLOCK_ELEMENTS // (n * n))
    for s in range(0, series.shape[0], step):
        y = (series[s:s + step].to(torch.float32) + sy).contiguous()
        out[s:s + step] = _psi_sums(x, x_sorted, dx, y, k, estimator)
    const = torch.special.digamma(torch.tensor(
        [float(k), float(n)], dtype=torch.float64)).sum().item()
    if estimator == 2:
        const -= 1.0 / k
    return torch.clamp(-out / n + const, min=0.0)


class _Columns:
    """The ``(V, n)`` series of member-major ``(E_c, V)`` blocks, rows
    gathered a slice at a time (no copy of the whole stack)."""

    def __init__(self, flats: list, voxels=None):
        self.flats, self.voxels = flats, voxels
        v = flats[0].shape[1] if voxels is None else int(voxels.numel())
        self.shape = (v, sum(f.shape[0] for f in flats))
        self.device = flats[0].device

    def __getitem__(self, rows: slice) -> torch.Tensor:
        cols = rows if self.voxels is None else self.voxels[rows]
        return torch.cat([f[:, cols] for f in self.flats]).T


def field(blocks, points, mix: dict, voxels=None) -> torch.Tensor:
    """``(R, V)`` float64 KSG MI of every voxel (or of the ``(K,)`` flat
    ``voxels``) against each reference voxel ``(x, y, z)`` of ``points``,
    with the mix's ``k`` and ``kraskov_estimator``; ``blocks`` the
    member-major ``(E_c, Z, Y, X)`` blocks of the data."""
    blocks = list(blocks)
    series = _Columns([b.reshape(b.shape[0], -1) for b in blocks], voxels)
    k = int(mix.get("k", 3))
    estimator = int(mix.get("kraskov_estimator", 1))
    return torch.stack([
        ksg_mi(series, torch.cat([b[:, z, y, x] for b in blocks]), k=k,
               estimator=estimator) for x, y, z in points])
