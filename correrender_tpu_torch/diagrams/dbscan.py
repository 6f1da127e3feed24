"""DBSCAN clustering via dense distance matrices.

A copy of ``correrender_tpu/diagrams/dbscan.py``. Replaces the
reference's vendored dbscan/ + nanoflann k-d tree
(DistributionSimilarityRenderer.cpp:651-652). For the embedding sizes
in play (≤ ~10⁴ 2D points) the density graph is a dense boolean
matrix; cluster expansion is a connected-components iteration over
core points (SURVEY.md §2.10 item 9).
"""

from __future__ import annotations

import numpy as np


def dbscan(points: np.ndarray, eps: float = 0.5, min_samples: int = 5
           ) -> np.ndarray:
    """Cluster (N, D) points; returns labels (N,), −1 = noise."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n == 0:
        return np.zeros(0, np.int64)
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    adj = d2 <= eps * eps  # includes self
    degree = adj.sum(axis=1)
    core = degree >= min_samples

    # Connected components over the core-core graph: min-label
    # propagation with POINTER JUMPING (labels[labels] each round), so
    # convergence is O(log diameter) matrix passes instead of
    # O(diameter) — filament-shaped t-SNE clusters made the plain
    # propagation O(n³) (round-3 review finding).
    labels = np.arange(n)
    core_adj = adj & core[None, :] & core[:, None]
    while True:
        neigh = np.where(core_adj, labels[None, :], n)
        new = np.minimum(labels, neigh.min(axis=1))
        # Path-halving: chase each label to its current representative.
        while True:
            jumped = new[new]
            if np.array_equal(jumped, new):
                break
            new = jumped
        if np.array_equal(new, labels):
            break
        labels = new

    out = np.full(n, -1, np.int64)
    out[core] = labels[core]
    # Border points: attach to any core neighbour's cluster.
    border = ~core & (adj & core[None, :]).any(axis=1)
    for i in np.nonzero(border)[0]:
        cores_near = np.nonzero(adj[i] & core)[0]
        out[i] = out[cores_near[0]]
    # Renumber clusters consecutively.
    uniq = np.unique(out[out >= 0])
    remap = {c: k for k, c in enumerate(uniq)}
    for i in range(n):
        if out[i] >= 0:
            out[i] = remap[out[i]]
    return out
