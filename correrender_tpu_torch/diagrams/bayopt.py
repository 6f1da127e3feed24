"""Bayesian-optimization block-pair sampler: GP(Matern-5/2) + UCB.

Counterpart of ``correrender_tpu/diagrams/bayopt.py``. Reference:
src/Renderers/Diagram/BayOpt.hpp (limbo GP, UCB acquisition, nlopt inner
optimizer, used per block pair at HEBChartCorrelation.cpp:909-918). The
GP posterior is a small dense solve (≤ ~100 points a pair), the inner
acquisition "optimizer" is a dense quasirandom candidate sweep, and —
like limbo's hyperparameter optimization (BayOpt.hpp:86-127) — the
kernel length scale is refit by maximum marginal likelihood over the
observed points (signal variance profiled out in closed form).

The batched sampler advances every pair's GP in lockstep, as the JAX
package's one-program ``lax.fori_loop`` does: a Python loop of batched
tensor operations on the stack's device, with fixed-capacity masked
buffers. Every iteration's candidates are drawn before the loop (the
JAX package's ``fold_in`` draws, :mod:`ops.noise`) and go up in one
copy, and the Cholesky factorizations do not check their result on the
host, so nothing inside the loop waits for the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from correrender_tpu_torch.diagrams.sampling import (
    _region_points,
    as_stack,
    batched_block_pairs_max,
    flat_sample_index,
    plastic_sequence,
    region_bounds,
)
from correrender_tpu_torch.ops.noise import fold_in_like_jax, uniform_like_jax
from correrender_tpu_torch.ops.registry import correlate, measure_from_id

#: Candidate length scales for the marginal-likelihood refit.
_LS_GRID = np.geomspace(0.05, 2.0, 12).astype(np.float32)

#: √5 in float32, the JAX package's weakly typed constant, and 1/3 in
#: float32: XLA divides by a constant as a product with its reciprocal.
_SQRT5 = float(np.float32(math.sqrt(5.0)))
_THIRD = float(np.float32(1.0 / 3.0))


def _cholesky(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a failed factorization is not checked on
    the host (it would wait for the device)."""
    return torch.linalg.cholesky_ex(k)[0]


def matern52(x1: torch.Tensor, x2: torch.Tensor, length_scale=0.3,
             variance=1.0) -> torch.Tensor:
    """Matern-5/2 kernel matrix between (N, D) and (M, D) points."""
    d = torch.sqrt(torch.clamp(
        ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1), min=1e-30))
    s = _SQRT5 * d / torch.as_tensor(length_scale, dtype=d.dtype,
                                     device=d.device)
    return variance * (1.0 + s + s * s * _THIRD) * torch.exp(-s)


def gp_posterior(x_train, y_train, x_query, length_scale, variance,
                 noise=1e-4, mask=None):
    """GP mean/std at query points (zero-mean prior, Matern-5/2).

    ``mask`` (0/1 per train point) supports fixed-capacity buffers:
    masked rows/columns of K collapse to the identity and their k*
    columns to zero, so the posterior equals the unmasked GP over the
    active subset.
    """
    if mask is None:
        mask = torch.ones(x_train.shape[0], dtype=x_train.dtype,
                          device=x_train.device)
    mm = mask[:, None] * mask[None, :]
    k = matern52(x_train, x_train, length_scale, variance) * mm
    eye = torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
    k = k + noise * eye + torch.diag(1.0 - mask)
    chol = _cholesky(k)
    alpha = torch.cholesky_solve((y_train * mask)[:, None], chol)[:, 0]
    k_star = (matern52(x_query, x_train, length_scale, variance)
              * mask[None, :])  # (Q, N)
    mean = k_star @ alpha
    v = torch.linalg.solve_triangular(chol, k_star.T, upper=False)
    var = torch.clamp(variance - (v * v).sum(0), min=1e-10)
    return mean, torch.sqrt(var)


def fit_gp_hyperparams(x_train, y_train, noise=1e-4, mask=None):
    """Max-marginal-likelihood (length_scale, variance) over a grid.

    With a unit-variance correlation matrix K_ls, the optimal signal
    variance is closed-form (σ² = yᵀK⁻¹y / N), so the profiled log
    marginal likelihood reduces to
        LML(ls) ∝ −N/2 · log σ²(ls) − ½ log|K_ls|.
    Batched over the candidate grid. Returns 0-d tensors.
    """
    cap = x_train.shape[0]
    dev = x_train.device
    if mask is None:
        mask = torch.ones(cap, dtype=x_train.dtype, device=dev)
    n = torch.clamp(mask.sum(), min=1.0)
    mm = mask[:, None] * mask[None, :]
    ym = y_train * mask
    ls = torch.as_tensor(_LS_GRID, device=dev)
    sq = ((x_train[:, None, :] - x_train[None, :, :]) ** 2).sum(-1)
    k = (_matern52_from_sq(sq[None], ls[:, None, None], 1.0) * mm
         + noise * torch.eye(cap, device=dev) + torch.diag(1.0 - mask))
    chol = _cholesky(k)
    alpha = torch.cholesky_solve(ym[None, :, None].expand(len(ls), -1, -1),
                                 chol)[..., 0]
    sigma2 = torch.clamp((ym[None] * alpha).sum(-1) / n, min=1e-10)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(-1)
    scores = -0.5 * n * torch.log(sigma2) - 0.5 * logdet
    best = torch.argmax(scores)
    return ls[best], sigma2[best]


def _pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances, (..., N, D) × (..., M, D) → (..., N, M),
    in the |x|²+|y|²−2x·y product form (O(N·M) working set)."""
    an = (a * a).sum(-1)
    bn = (b * b).sum(-1)
    ab = a @ b.transpose(-1, -2)
    return torch.clamp(an[..., :, None] + bn[..., None, :] - 2.0 * ab,
                       min=0.0)


def _matern52_from_sq(sq, length_scale, variance):
    """Matern-5/2 of squared distances; ``length_scale`` is a tensor
    (a division by a Python number runs as a reciprocal product on a
    GPU)."""
    d = torch.sqrt(torch.clamp(sq, min=1e-30))
    s = _SQRT5 * d / length_scale
    return variance * (1.0 + s + s * s * _THIRD) * torch.exp(-s)


def candidate_draws(seed: int, num_iters: int,
                    num_candidates: int) -> np.ndarray:
    """``(num_iters, C, 6)`` float32: iteration ``it``'s candidates are
    ``jax.random.uniform(fold_in(key(seed), it), (C, 6))``."""
    return np.stack([
        uniform_like_jax(fold_in_like_jax(seed, it), (num_candidates, 6))
        for it in range(num_iters)]) if num_iters else np.zeros(
            (0, num_candidates, 6), np.float32)


def _batched_bayopt(flat, shape, lo_a, hi_a, lo_b, hi_b, u_init, cand, m,
                    kw, num_init, num_iters, kappa, refit_every, noise,
                    signed):
    """All pairs' GP-UCB loops of one pair chunk, in lockstep on the
    stack's device (the JAX package's ``_batched_bayopt_program``).
    Returns the ``(p,)`` maxima."""
    dev = flat.device
    # float32, as in the JAX package; a float64 stack runs the same
    # loop in float64 (tests use it to tell rounding ties from faults).
    dt = torch.float64 if flat.dtype == torch.float64 else torch.float32
    p = lo_a.shape[0]
    cap = num_init + num_iters
    eye = torch.eye(cap, dtype=dt, device=dev)
    ls_grid = torch.as_tensor(_LS_GRID, dtype=dt, device=dev)
    u_init, cand = u_init.to(dt), cand.to(dt)

    def eval_points(u6):
        # u6: (p, 6) or (S, 6) shared → the SIGNED correlation at one
        # sampled voxel pair per region pair and sample. The GP models
        # |corr|; signed charts report the sign at the winning probe.
        ia = flat_sample_index(shape, lo_a, hi_a, u6[..., :3])
        ib = flat_sample_index(shape, lo_b, hi_b, u6[..., 3:])
        return correlate(flat[ia], flat[ib], m, absolute=False, **kw)

    def eval_own(x_new):
        # One sample a pair: the pair's own (p, 6) position.
        return eval_points(x_new[:, None, :])[:, 0]

    def chol_terms(x, y_c, mask, ls, var):
        sq = _pairwise_sqdist(x, x)
        mm = mask[:, :, None] * mask[:, None, :]
        k = (_matern52_from_sq(sq, ls[:, None, None], var[:, None, None])
             * mm + noise * eye + (1.0 - mask)[:, :, None] * eye)
        chol = _cholesky(k)
        alpha = torch.cholesky_solve(y_c[..., None], chol)[..., 0]
        return chol, alpha

    def refit(x, y_c, mask, nact):
        # Per-pair profiled-LML grid refit (fit_gp_hyperparams' math);
        # the first grid value with the best score wins.
        sq = _pairwise_sqdist(x, x)
        mm = mask[:, :, None] * mask[:, None, :]
        best_score = torch.full((p,), -torch.inf, dtype=dt, device=dev)
        best_ls = torch.full((p,), 0.3, dtype=dt, device=dev)
        best_var = torch.ones((p,), dtype=dt, device=dev)
        for ls in ls_grid:
            k = (_matern52_from_sq(sq, ls, 1.0) * mm + noise * eye
                 + (1.0 - mask)[:, :, None] * eye)
            chol = _cholesky(k)
            alpha = torch.cholesky_solve(y_c[..., None], chol)[..., 0]
            sigma2 = torch.clamp((y_c * alpha).sum(1) / nact, min=1e-10)
            logdet = 2.0 * torch.log(
                torch.diagonal(chol, dim1=1, dim2=2)).sum(1)
            score = -0.5 * nact * torch.log(sigma2) - 0.5 * logdet
            better = score > best_score
            best_score = torch.where(better, score, best_score)
            best_ls = torch.where(better, ls, best_ls)
            best_var = torch.where(better, sigma2, best_var)
        return best_ls, best_var

    # -- init: num_init plastic points shared across pairs --------------
    x = torch.zeros((p, cap, 6), dtype=dt, device=dev)
    x[:, :num_init] = u_init[None]
    y_init = eval_points(u_init)  # (p, num_init)
    # A pair whose probes are ALL NaN (fully masked regions) returns NaN
    # like every other sampler; NaN probes are zero-filled for the GP
    # (it needs finite y) but tracked.
    seen = torch.isfinite(y_init).any(dim=1)
    y = torch.zeros((p, cap), dtype=dt, device=dev)
    ysgn = torch.zeros_like(y)
    y[:, :num_init] = torch.nan_to_num(y_init).abs()
    ysgn[:, :num_init] = torch.nan_to_num(y_init)
    iota = torch.arange(cap, dtype=dt, device=dev)
    ls = torch.full((p,), 0.3, dtype=dt, device=dev)
    var = torch.ones((p,), dtype=dt, device=dev)
    for it in range(num_iters):
        count = num_init + it
        mask = (iota[None, :] < count).to(dt).expand(p, cap)
        # A fill kernel, not a copy from the host (which would wait).
        nact = torch.full((), float(count), dtype=dt, device=dev)
        ymean = (y * mask).sum(1) / nact
        y_c = (y - ymean[:, None]) * mask
        if it % refit_every == 0:
            ls, var = refit(x, y_c, mask, nact)
        chol, alpha = chol_terms(x, y_c, mask, ls, var)
        candidates = cand[it]
        sq_star = _pairwise_sqdist(candidates[None], x)  # (p, C, cap)
        k_star = (_matern52_from_sq(sq_star, ls[:, None, None],
                                    var[:, None, None]) * mask[:, None, :])
        mean = torch.einsum("pck,pk->pc", k_star, alpha)
        v = torch.linalg.solve_triangular(chol, k_star.transpose(1, 2),
                                          upper=False)  # (p, cap, C)
        varq = torch.clamp(var[:, None] - (v * v).sum(1), min=1e-10)
        ucb = mean + ymean[:, None] + kappa * torch.sqrt(varq)
        x_new = candidates[torch.argmax(ucb, dim=1)]  # (p, 6)
        y_new = eval_own(x_new)
        seen = seen | torch.isfinite(y_new)
        x[:, count] = x_new
        y[:, count] = torch.nan_to_num(y_new).abs()
        ysgn[:, count] = torch.nan_to_num(y_new)
    if signed:
        idx = torch.argmax(y, dim=1)
        best = torch.take_along_dim(ysgn, idx[:, None], dim=1)[:, 0]
    else:
        best = y.amax(dim=1)
    return torch.where(seen, best, torch.nan)


def batched_bayesian_opt_max(
    stack,
    regions_a,
    regions_b,
    measure="pearson",
    num_init: int = 20,
    num_iters: int = 60,
    kappa: float = 1.5,
    num_candidates: int = 512,
    seed: int = 0,
    refit_every: int = 10,
    pair_chunk: int = 2048,
    **measure_kw,
) -> np.ndarray:
    """GP-UCB max |corr| for MANY region pairs at once → (P,) floats.
    The regions are GridRegion sequences or ``(P, 6)`` bound arrays
    (``sampling.region_bounds``).

    Same estimator as :func:`bayesian_opt_max`, but every pair's GP
    advances in lockstep on the stack's device; pairs are chunked to
    bound the (chunk, cap, cap) Cholesky workspace, and a short batch or
    the final chunk is padded to the canonical chunk size, as in the JAX
    package. With ``absolute=False`` in ``measure_kw`` the GP still
    maximizes |corr| and the reported value keeps its sign.
    """
    m = measure_from_id(measure)
    absolute = bool(measure_kw.pop("absolute", True))
    stack = as_stack(stack)
    if num_iters <= 0:
        # Pure quasirandom budget — no GP to run.
        return batched_block_pairs_max(
            stack, regions_a, regions_b, m, method="plastic",
            num_samples=max(num_init, 1), absolute=absolute, **measure_kw)
    dev = stack.device
    flat = stack.reshape(-1, stack.shape[-1])
    u_init = torch.as_tensor(plastic_sequence(num_init, 6),
                             dtype=torch.float32, device=dev)
    cand = torch.as_tensor(
        candidate_draws(seed, num_iters, num_candidates), device=dev)
    p = len(regions_a)
    if p < pair_chunk:
        pair_chunk = 1 << (p - 1).bit_length() if p > 1 else 1
    outs = []
    for start in range(0, p, pair_chunk):
        ra = regions_a[start:start + pair_chunk]
        rb = regions_b[start:start + pair_chunk]
        pad = pair_chunk - len(ra)
        bounds = (*region_bounds(ra, dev), *region_bounds(rb, dev))
        if pad:
            zeros = torch.zeros((pad, 3), dtype=torch.int32, device=dev)
            bounds = tuple(torch.cat([b, zeros]) for b in bounds)
        outs.append(_batched_bayopt(
            flat, stack.shape, *bounds, u_init, cand, m, measure_kw,
            num_init, num_iters, float(kappa), int(refit_every), 1e-4,
            not absolute)[:len(ra)])
    if not outs:
        return np.zeros(0, np.float32)
    return torch.cat(outs).cpu().numpy()


def bayesian_opt_max(
    stack,
    region_a,
    region_b,
    measure="pearson",
    num_init: int = 20,
    num_iters: int = 60,
    kappa: float = 1.5,
    num_candidates: int = 512,
    seed: int = 0,
    refit_every: int = 10,
    **measure_kw,
) -> float:
    """Max |corr| over A×B via GP-UCB on the 6D pair-position space, one
    pair at a time (candidates from ``numpy.random.default_rng(seed)``).

    With ``absolute=False`` in ``measure_kw`` the GP still maximizes
    |corr| but the return value keeps the sign at the winning probe.
    """
    stack = as_stack(stack)
    dev = stack.device
    flat = stack.reshape(-1, stack.shape[-1])
    zs, ys, xs = stack.shape[:3]
    absolute = bool(measure_kw.pop("absolute", True))

    def evaluate(u6: np.ndarray) -> np.ndarray:
        pa = _region_points(region_a, u6[:, :3])
        pb = _region_points(region_b, u6[:, 3:])
        ia = torch.as_tensor((pa[:, 2] * ys + pa[:, 1]) * xs + pa[:, 0],
                             device=dev)
        ib = torch.as_tensor((pb[:, 2] * ys + pb[:, 1]) * xs + pb[:, 0],
                             device=dev)
        vals = correlate(flat[ia], flat[ib], measure, absolute=False,
                         **measure_kw)
        return torch.nan_to_num(vals, nan=0.0).cpu().numpy()

    # Fixed-capacity masked buffers, as in the batched sampler.
    cap = num_init + num_iters
    x = np.zeros((cap, 6), np.float32)
    y = np.zeros(cap, np.float32)  # |corr| — the GP's objective
    ysgn = np.zeros(cap, np.float32)  # signed value at the same probe
    x[:num_init] = plastic_sequence(num_init, 6)
    ysgn[:num_init] = evaluate(x[:num_init])
    y[:num_init] = np.abs(ysgn[:num_init])
    count = num_init

    rng = np.random.default_rng(seed)
    ls, var = 0.3, 1.0
    for it in range(num_iters):
        mask = np.zeros(cap, np.float32)
        mask[:count] = 1.0
        y_mean = y[:count].mean()
        y_c = np.where(mask > 0, y - y_mean, 0.0).astype(np.float32)
        xt, yt, mt = (torch.as_tensor(a, device=dev) for a in (x, y_c, mask))
        if it % refit_every == 0:
            ls_t, var_t = fit_gp_hyperparams(xt, yt, mask=mt)
            ls, var = float(ls_t), float(var_t)
        candidates = rng.random((num_candidates, 6))
        mean, std = gp_posterior(
            xt, yt, torch.as_tensor(candidates, dtype=torch.float32,
                                    device=dev),
            float(np.float32(ls)), float(np.float32(var)), mask=mt)
        ucb = mean.cpu().numpy() + y_mean + kappa * std.cpu().numpy()
        best = np.argmax(ucb)
        x[count] = candidates[best].astype(np.float32)
        ysgn[count] = evaluate(x[count:count + 1])[0]
        y[count] = abs(ysgn[count])
        count += 1

    if absolute:
        return float(y[:count].max())
    return float(ysgn[:count][int(np.argmax(y[:count]))])
