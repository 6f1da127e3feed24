"""t-SNE embedding (exact O(n²)) on the input's device.

Counterpart of ``correrender_tpu/diagrams/tsne.py``, which replaces the
reference's vendored Barnes-Hut C++ t-SNE
(src/Renderers/Diagram/DistributionSimilarity/ + bhtsne/,
DistributionSimilarityRenderer.cpp:636-639): for the ~10³–10⁴ points
the distribution-similarity view uses, the exact gradient is a dense
``n × n`` tensor program. The initial embedding is the JAX package's
``1e-4 · normal(key(seed), (n, 2))`` draw bit for bit
(:func:`ops.noise.normal_like_jax`), made on the host and moved to the
device; the loops run there without waiting on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.ops.noise import normal_like_jax


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    s = (x * x).sum(1)
    d = s[:, None] - 2.0 * (x @ x.T) + s[None, :]
    return torch.clamp(d, min=0.0)


def _binary_search_perplexity(d2: torch.Tensor, perplexity: float,
                              iters: int = 32) -> torch.Tensor:
    """Per-point beta (1/2σ²) matching the target perplexity; returns
    the conditional probabilities."""
    n = d2.shape[0]
    dev = d2.device
    # log of the float32 perplexity, rounded once (XLA folds it so).
    log_perp = float(np.float32(np.log(np.float64(np.float32(perplexity)))))
    eye = torch.eye(n, dtype=torch.bool, device=dev)

    def entropy_and_p(beta):
        p = torch.exp(-d2 * beta[:, None])
        p = torch.where(eye, 0.0, p)
        sum_p = torch.clamp(p.sum(1), min=1e-12)
        h = torch.log(sum_p) + beta * (d2 * p).sum(1) / sum_p
        return h, p / sum_p[:, None]

    beta = torch.ones(n, device=dev)
    lo = torch.zeros(n, device=dev)
    hi = torch.full((n,), torch.inf, device=dev)
    for _ in range(iters):
        h, _ = entropy_and_p(beta)
        too_high = h > log_perp  # entropy too high → increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
    _, p = entropy_and_p(beta)
    return p


def tsne_initial(n: int, seed: int = 0) -> np.ndarray:
    """The ``(n, 2)`` float32 initial embedding
    ``1e-4 · jax.random.normal(key(seed), (n, 2))``."""
    return normal_like_jax(seed, (n, 2), scale=1e-4)


def tsne(
    features,
    perplexity: float = 30.0,
    num_iters: int = 500,
    seed: int = 0,
    early_exag_iters: int = 100,
) -> torch.Tensor:
    """2D t-SNE embedding of (N, D) feature vectors (an array becomes a
    CPU tensor) → ``(N, 2)`` float32 on the features' device."""
    x = torch.as_tensor(features)
    x = x.to(torch.float32)
    n = x.shape[0]
    dev = x.device
    perplexity = min(perplexity, (n - 1) / 3.0)
    d2 = _pairwise_sq_dists(x)
    p_cond = _binary_search_perplexity(d2, float(perplexity))
    # XLA divides by the constant 2n as a product with its reciprocal.
    p = (p_cond + p_cond.T) * float(np.float32(1.0 / np.float32(2.0 * n)))
    p = torch.clamp(p, min=1e-12)
    y = torch.as_tensor(tsne_initial(n, seed), device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    vel = torch.zeros_like(y)
    gains = torch.ones_like(y)
    for i in range(num_iters):
        exag = 12.0 if i < early_exag_iters else 1.0
        dy2 = _pairwise_sq_dists(y)
        q_num = torch.where(eye, 0.0, 1.0 / (1.0 + dy2))
        q = torch.clamp(q_num / q_num.sum(), min=1e-12)
        pq = (exag * p - q) * q_num  # (n, n)
        g = 4.0 * (pq.sum(1, keepdim=True) * y - pq @ y)
        # van der Maaten gains: grow when the gradient opposes velocity.
        same_sign = (g > 0) == (vel > 0)
        gains = torch.clamp(torch.where(same_sign, gains * 0.8,
                                        gains + 0.2), min=0.01)
        momentum = 0.5 if i < 250 else 0.8
        vel = momentum * vel - 200.0 * gains * g
        y = y + vel
        y = y - y.mean(0, keepdim=True)
    return y
