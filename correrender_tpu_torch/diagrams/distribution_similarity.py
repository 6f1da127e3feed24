"""Distribution-similarity feature builders + embedding pipeline.

Counterpart of ``correrender_tpu/diagrams/distribution_similarity.py``.
Reference: src/Renderers/Diagram/DistributionSimilarity/
(DistributionSimilarityRenderer.hpp:49-66,114-117) — three feature modes
over a sampled point set, embedded with t-SNE and clustered with DBSCAN,
colored back into the 3D view:

* grid-cell neighborhood-correlation vectors,
* grid-cell member-value vectors,
* member grid-cell-value vectors,

sampling patterns {all, quasirandom plastic}. The features are gathered
and the embedding computed on the stack's device; DBSCAN runs on the
host over the ``(N, 2)`` embedding.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.diagrams.dbscan import dbscan
from correrender_tpu_torch.diagrams.sampling import as_stack, plastic_sequence
from correrender_tpu_torch.diagrams.tsne import tsne
from correrender_tpu_torch.ops.registry import correlate

FEATURE_MODES = (
    "cell_neighborhood_correlations",
    "cell_member_values",
    "member_cell_values",
)


def sample_cells(shape_zyx, max_points: int = 2000, pattern: str = "plastic"):
    """Sample voxel coordinates: 'all' or quasirandom 'plastic'."""
    zs, ys, xs = shape_zyx
    total = zs * ys * xs
    if pattern == "all" or total <= max_points:
        idx = np.arange(total)
    elif pattern == "plastic":
        u = plastic_sequence(max_points, 3)
        coords = np.minimum(
            (u * np.array([zs, ys, xs])).astype(np.int64),
            np.array([zs - 1, ys - 1, xs - 1]),
        )
        idx = np.unique(
            (coords[:, 0] * ys + coords[:, 1]) * xs + coords[:, 2]
        )
    else:
        raise ValueError(f"unknown sampling pattern {pattern!r}")
    z = idx // (ys * xs)
    y = (idx // xs) % ys
    x = idx % xs
    return np.stack([z, y, x], axis=-1)


def _at(stack: torch.Tensor, z, y, x) -> torch.Tensor:
    """The ``(N, n)`` series at voxel coordinates (host arrays)."""
    zs, ys, xs = stack.shape[:3]
    flat = torch.as_tensor((z * ys + y) * xs + x, device=stack.device)
    return stack.reshape(-1, stack.shape[-1])[flat]


def build_features(
    stack,
    mode: str = "cell_member_values",
    max_points: int = 2000,
    pattern: str = "plastic",
    neighborhood: int = 2,
    measure: str = "pearson",
):
    """Feature matrix ``(N, D)`` float32 on the stack's device + the
    sampled cell coords (or member ids) as a host array."""
    stack = as_stack(stack)
    zs, ys, xs, n = stack.shape
    cells = sample_cells((zs, ys, xs), max_points, pattern)
    if mode in ("cell_member_values", "member_cell_values"):
        vals = _at(stack, cells[:, 0], cells[:, 1], cells[:, 2])  # (N, n)
        # Drop NaN-carrying cells (masked/fill voxels): one NaN row
        # poisons every pairwise t-SNE distance.
        ok = torch.isfinite(vals).all(dim=-1)
        ok_host = ok.cpu().numpy()
        vals = vals[ok].to(torch.float32)
        if mode == "cell_member_values":
            return vals, cells[ok_host]
        # Feature axis = sampled cells (members comparable across the
        # cells kept).
        return vals.T.contiguous(), np.arange(n)  # (n, N_ok)
    if mode == "cell_neighborhood_correlations":
        r = neighborhood
        offsets = [
            (dz, dy, dx)
            for dz in (-r, 0, r)
            for dy in (-r, 0, r)
            for dx in (-r, 0, r)
            if (dz, dy, dx) != (0, 0, 0)
        ]
        center = _at(stack, cells[:, 0], cells[:, 1], cells[:, 2])
        feats = []
        for dz, dy, dx in offsets:
            zq = np.clip(cells[:, 0] + dz, 0, zs - 1)
            yq = np.clip(cells[:, 1] + dy, 0, ys - 1)
            xq = np.clip(cells[:, 2] + dx, 0, xs - 1)
            feats.append(correlate(center, _at(stack, zq, yq, xq), measure))
        return torch.nan_to_num(torch.stack(feats, dim=-1)).to(
            torch.float32), cells
    raise ValueError(f"unknown feature mode {mode!r}")


def distribution_similarity(
    stack,
    mode: str = "cell_member_values",
    max_points: int = 1000,
    perplexity: float = 30.0,
    eps: float | None = None,
    min_samples: int = 8,
    seed: int = 0,
    num_iters: int = 500,
):
    """Full pipeline: features → t-SNE 2D embedding → DBSCAN labels.

    Returns (embedding (N, 2) float32 array, labels (N,), ids) where ids
    are the sampled cell coords (or member indices for member mode).
    """
    feats, ids = build_features(stack, mode, max_points)
    emb = tsne(feats, perplexity=perplexity, seed=seed,
               num_iters=num_iters).cpu().numpy()
    if eps is None:
        span = emb.max(axis=0) - emb.min(axis=0)
        eps = 0.05 * float(np.linalg.norm(span))
    labels = dbscan(emb, eps=eps, min_samples=min_samples)
    return emb, labels, ids
