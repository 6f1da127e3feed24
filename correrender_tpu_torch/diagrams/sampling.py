"""Block-pair maximum-correlation samplers for the HEB chart.

Counterpart of ``correrender_tpu/diagrams/sampling.py``. Reference:
src/Renderers/Diagram/Sampling.{hpp,cpp} — estimating
``max_{(i,j) ∈ A×B} |corr(i, j)|`` for a pair of octree regions without
evaluating all |A|·|B| voxel pairs. Methods (Sampling.hpp:34-40): Mean
(on downscaled block means), Random-Uniform, Quasirandom Halton,
Quasirandom Plastic, and Bayesian Optimization (bayopt.py).

Sample positions come from numpy, as in the JAX package, so both place
every sample on the same voxel. The stack stays on its device: the
batched samplers send up only the region bounds and the shared unit
samples, and gather, correlate and max-reduce each chunk of pairs there;
only the per-pair maxima come back.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.diagrams.octree import nanmean_exact
from correrender_tpu_torch.ops.registry import (
    correlate,
    is_measure_binned_mi,
    is_measure_kraskov_mi,
    measure_from_id,
)


def halton(index: np.ndarray, base: int) -> np.ndarray:
    """Halton low-discrepancy sequence values for 1-based indices."""
    result = np.zeros(index.shape, np.float64)
    f = 1.0 / base
    i = index.astype(np.int64).copy()
    while np.any(i > 0):
        result += f * (i % base)
        i //= base
        f /= base
    return result


def plastic_sequence(n: int, dim: int) -> np.ndarray:
    """R_d quasirandom ('plastic') sequence in [0,1)^dim."""
    # Generalized golden ratio: x^(dim+1) = x + 1.
    phi = 2.0
    for _ in range(30):
        phi = (1 + phi) ** (1.0 / (dim + 1))
    alpha = np.array([1.0 / phi ** (k + 1) for k in range(dim)])
    idx = np.arange(1, n + 1)[:, None]
    return (0.5 + idx * alpha[None, :]) % 1.0


def as_stack(stack) -> torch.Tensor:
    """A ``(Z, Y, X, n)`` member stack as a tensor (an array becomes a
    CPU tensor; a tensor stays where it is)."""
    return stack if isinstance(stack, torch.Tensor) else torch.as_tensor(
        np.asarray(stack))


def _region_points(region, u: np.ndarray) -> np.ndarray:
    """Map unit-cube samples to integer voxel coords (x, y, z) of a
    region, with the f32 ``lo + u·(hi−lo+1)`` map of the batched
    samplers, so both place samples at the same voxels."""
    lo = np.array([region.x_min, region.y_min, region.z_min])
    hi = np.array([region.x_max, region.y_max, region.z_max])
    pts = (lo.astype(np.float32)
           + u.astype(np.float32) * (hi - lo + 1).astype(np.float32))
    return np.minimum(pts.astype(np.int64), hi)


def _gather(stack: torch.Tensor, pts: np.ndarray) -> torch.Tensor:
    """The ``(S, n)`` series at (x, y, z) voxel coordinates."""
    zs, ys, xs = stack.shape[:3]
    flat = (pts[:, 2] * ys + pts[:, 1]) * xs + pts[:, 0]
    return stack.reshape(-1, stack.shape[-1])[
        torch.as_tensor(flat, device=stack.device)]


def _pairs_to_series(stack, region_a, region_b, ua, ub):
    return (_gather(stack, _region_points(region_a, ua)),
            _gather(stack, _region_points(region_b, ub)))


def _best(vals: torch.Tensor, absolute: bool) -> torch.Tensor:
    """Per-row maximum correlation of ``(P, S)`` values, NaN where a row
    holds no finite value. Signed mode: the "maximum correlation" of a
    block pair is the strongest relationship, so the value of largest
    magnitude is returned with its sign."""
    finite = torch.isfinite(vals)
    if absolute:
        best = torch.where(finite, vals, -torch.inf).amax(dim=1)
    else:
        mag = torch.where(finite, vals.abs(), -torch.inf)
        best = torch.take_along_dim(vals, mag.argmax(dim=1)[:, None],
                                    dim=1)[:, 0]
    return torch.where(finite.any(dim=1), best, torch.nan)


def _eval_max(sa, sb, measure, **kw) -> float:
    absolute = kw.pop("absolute", True)
    vals = correlate(sa, sb, measure, absolute=absolute, **kw)
    return float(_best(vals.reshape(1, -1), absolute)[0])


def sample_mean(stack, region_a, region_b, measure, num_samples=None,
                seed=None, subsample: int = 1, **kw):
    """Mean method: correlation of the two regions' block-mean series
    (computeCorrelationsMean on downscaled fields,
    HEBChartCorrelation.cpp:457). ``subsample`` strides the voxels
    entering the mean — the reference's mean-field subsampling factor f
    (SamplingTest.cpp test-case parameter)."""
    stack = as_stack(stack)

    def region_mean_series(r):
        sub = stack[
            r.z_min : r.z_max + 1 : subsample,
            r.y_min : r.y_max + 1 : subsample,
            r.x_min : r.x_max + 1 : subsample,
        ]
        return nanmean_exact(sub.reshape(-1, sub.shape[-1]), 0)

    sa = region_mean_series(region_a)[None]
    sb = region_mean_series(region_b)[None]
    return _eval_max(sa, sb, measure, **kw)


def _unit_samples(method: str, s: int, seed=0):
    """The ``(S, 3)`` unit samples of region A and of region B."""
    if method == "random":
        rng = np.random.default_rng(seed)
        return rng.random((s, 3)), rng.random((s, 3))
    if method == "halton":
        idx = np.arange(1, s + 1)
        return (np.stack([halton(idx, b) for b in (2, 3, 5)], axis=-1),
                np.stack([halton(idx, b) for b in (7, 11, 13)], axis=-1))
    if method == "plastic":
        u = plastic_sequence(s, 6)
        return u[:, :3], u[:, 3:]
    raise ValueError(f"batched sampling: unknown method {method!r}")


def sample_random(stack, region_a, region_b, measure, num_samples=100,
                  seed=0, **kw):
    ua, ub = _unit_samples("random", num_samples, seed)
    sa, sb = _pairs_to_series(as_stack(stack), region_a, region_b, ua, ub)
    return _eval_max(sa, sb, measure, **kw)


def sample_halton(stack, region_a, region_b, measure, num_samples=100,
                  seed=None, **kw):
    ua, ub = _unit_samples("halton", num_samples)
    sa, sb = _pairs_to_series(as_stack(stack), region_a, region_b, ua, ub)
    return _eval_max(sa, sb, measure, **kw)


def sample_plastic(stack, region_a, region_b, measure, num_samples=100,
                   seed=None, **kw):
    ua, ub = _unit_samples("plastic", num_samples)
    sa, sb = _pairs_to_series(as_stack(stack), region_a, region_b, ua, ub)
    return _eval_max(sa, sb, measure, **kw)


def sample_bayopt(stack, region_a, region_b, measure, num_samples=100,
                  num_init=20, seed=0, **kw):
    from correrender_tpu_torch.diagrams.bayopt import bayesian_opt_max

    return bayesian_opt_max(
        stack, region_a, region_b, measure,
        num_init=min(num_init, num_samples),
        num_iters=max(num_samples - num_init, 0),
        seed=seed, **kw,
    )


SAMPLING_METHODS = {
    "mean": sample_mean,
    "random": sample_random,
    "halton": sample_halton,
    "plastic": sample_plastic,
    "bayesian": sample_bayopt,
}


def sample_block_pair_max(
    stack, region_a, region_b, measure="pearson", method="plastic",
    stack_means=None, **kw,
):
    """Estimate max |corr| between two regions with the chosen method.

    ``stack_means`` is accepted for API compatibility but unused — the
    mean method derives region means from the stack directly.
    """
    del stack_means
    return SAMPLING_METHODS[method](stack, region_a, region_b, measure, **kw)


#: Bytes of gathered pair series per request chunk (the JAX package's
#: budget): 2·n·4 bytes a request.
_GATHER_BUDGET = 128 << 20


def transient_budget(device) -> int:
    """Bytes a request chunk's measure may hold at once. The JAX package
    gives KSG's dense ``(R, n, n)`` neighbour problem 4 GB of a TPU's
    16 GB. An H100 has 80 GB, of which the headline's member stack (250³
    × 100 float32) takes 6.25 GB and a Scene's caches as much again, so a
    chunk may take 8 GiB there. On the CPU, which shares the host's
    memory, a chunk keeps to 512 MiB."""
    return (8 << 30) if torch.device(device).type == "cuda" else (512 << 20)


def request_bytes(measure, n: int, num_bins: int = 80) -> int:
    """Bytes the port's plain torch measure holds per request of ``n``
    members: Kendall's ``(n, 128)`` tiles (eight float32 arrays), KSG's
    ``(n, n)`` rows (six), binned MI's one-hot rows (int64 and float32,
    for x and y) and ``bins²`` joint tables, else a few ``(n,)`` rows."""
    m = measure_from_id(measure)
    if is_measure_kraskov_mi(m):
        return 6 * 4 * n * n
    if is_measure_binned_mi(m):
        return 2 * 12 * n * num_bins + 12 * num_bins ** 2
    if m.value == "kendall":
        return 8 * 4 * n * min(n, 128)
    return 16 * n


def request_chunk_size(measure, n_members: int, device,
                       num_bins: int = 80) -> int:
    """Requests per chunk: the JAX package's rule — the gathered series
    under 128 MB, the measure's own working set (JAX bounds KSG's three
    ``(R, n, n)`` arrays) under the transient budget, a power of two in
    [256, 262144] — with the port's working sets
    (:func:`request_bytes`) and the device's budget
    (:func:`transient_budget`)."""
    chunk = min(_GATHER_BUDGET // (2 * 4 * n_members),
                transient_budget(device)
                // request_bytes(measure, n_members, num_bins))
    chunk = int(min(262144, max(256, chunk)))
    return 1 << (chunk.bit_length() - 1)


def region_bounds(regions, device) -> tuple:
    """``(P, 3)`` int32 (x, y, z) lower and upper bounds on ``device``.
    ``regions`` is a sequence of GridRegion, or a ``(P, 6)`` integer
    array of ``(x_min, y_min, z_min, x_max, y_max, z_max)`` rows (the HEB
    chart's pairs, without a Python object a region)."""
    if isinstance(regions, np.ndarray):
        rows = regions.astype(np.int32).reshape(-1, 6)
        lo, hi = rows[:, :3], rows[:, 3:]
    else:
        lo = np.array([[r.x_min, r.y_min, r.z_min] for r in regions],
                      np.int32).reshape(-1, 3)
        hi = np.array([[r.x_max, r.y_max, r.z_max] for r in regions],
                      np.int32).reshape(-1, 3)
    return (torch.as_tensor(lo, device=device),
            torch.as_tensor(hi, device=device))


def flat_sample_index(stack_shape, lo: torch.Tensor, hi: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Flat voxel indices ``(P, S)`` of unit samples in ``P`` regions, on
    the regions' device: the f32 ``lo + u·(hi−lo+1)`` map of
    :func:`_region_points`, truncated and clamped to ``hi``. ``u`` is
    ``(S, 3)``, shared by the regions, or ``(P, S, 3)``."""
    zs, ys, xs = stack_shape[:3]
    width = (hi - lo + 1).to(torch.float32)
    u = (u if u.dim() == 3 else u[None]).to(torch.float32)
    pts = torch.minimum(
        (lo.to(torch.float32)[:, None, :] + u * width[:, None, :]).to(
            torch.int32),
        hi[:, None, :]).to(torch.int64)
    return (pts[..., 2] * ys + pts[..., 1]) * xs + pts[..., 0]


def batched_block_pairs_max(
    stack,
    regions_a,
    regions_b,
    measure="pearson",
    method="plastic",
    num_samples=100,
    seed=0,
    request_chunk=None,
    **kw,
) -> np.ndarray:
    """Max |corr| for MANY region pairs, chunk by chunk on the stack's
    device.

    The reference batches all block-pair probes of a sampling round
    through one GPU request-mode dispatch (HEBChartCorrelation.cpp:1261).
    The sample positions are shared across pairs, exactly what the
    per-pair samplers produce with their fixed seeds.

    Args:
      stack: ``(Z, Y, X, n)`` member stack (a tensor stays on its device).
      regions_a / regions_b: sequences of GridRegion, or ``(P, 6)``
        bound arrays (see :func:`region_bounds`).
      method: "random" | "halton" | "plastic".
      seed: affects sample positions for method="random" only.
      request_chunk: requests a chunk; by default
        :func:`request_chunk_size`.
      **kw: measure kwargs; ``absolute`` (default True) selects |corr|.

    Returns:
      (P,) float32 max |corr| per pair (NaN where all probes are NaN).
    """
    stack = as_stack(stack)
    s = num_samples
    ua, ub = _unit_samples(method, s, seed)
    m = measure_from_id(measure)
    p = len(regions_a)
    if request_chunk is None:
        request_chunk = request_chunk_size(
            m, int(stack.shape[-1]), stack.device, kw.get("num_bins", 80))
    pair_chunk = max(request_chunk // s, 1)
    absolute = kw.pop("absolute", True)
    dev = stack.device
    lo_a, hi_a = region_bounds(regions_a, dev)
    lo_b, hi_b = region_bounds(regions_b, dev)
    ua_dev = torch.as_tensor(ua, dtype=torch.float32, device=dev)
    ub_dev = torch.as_tensor(ub, dtype=torch.float32, device=dev)
    flat = stack.reshape(-1, stack.shape[-1])
    outs = []
    for c in range(0, p, pair_chunk):
        sl = slice(c, c + pair_chunk)
        ia = flat_sample_index(stack.shape, lo_a[sl], hi_a[sl], ua_dev)
        ib = flat_sample_index(stack.shape, lo_b[sl], hi_b[sl], ub_dev)
        vals = correlate(flat[ia.reshape(-1)], flat[ib.reshape(-1)], m,
                         absolute=absolute, **kw)
        outs.append(_best(vals.reshape(ia.shape), absolute))
    if not outs:
        return np.zeros(0, np.float32)
    return torch.cat(outs).cpu().numpy()


def exhaustive_block_pair_max(stack, region_a, region_b, measure="pearson",
                              **kw):
    """Ground truth: evaluate ALL voxel pairs (test harness use only)."""
    stack = as_stack(stack)

    def region_series(r):
        sub = stack[
            r.z_min : r.z_max + 1,
            r.y_min : r.y_max + 1,
            r.x_min : r.x_max + 1,
        ]
        return sub.reshape(-1, sub.shape[-1])

    absolute = kw.pop("absolute", True)
    vals = correlate(region_series(region_a)[:, None, :],
                     region_series(region_b)[None, :, :], measure,
                     absolute=absolute, **kw)
    return float(_best(vals.reshape(1, -1), absolute)[0])
