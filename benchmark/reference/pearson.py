"""Pearson fields from float64 moments, in voxel blocks.

The data is an iterable of member-major blocks ``(E_c, Z, Y, X)``: one
block holding every member, or the member chunks of a streamed stack,
read once in order. For ``R`` reference points at once, each block
gives its part of every reference series and of the moments: Σy and Σy²
do not depend on the reference, Σxy is a product with the ``(R, E_c)``
reference rows.
"""

from __future__ import annotations

import torch

#: float64 elements of one block's working copy (1 GiB).
BLOCK_ELEMENTS = 1 << 27


def pearson_fields(chunks, points, voxels=None) -> torch.Tensor:
    """``(R, V)`` float64 Pearson r of every voxel's member series
    against the series of each reference voxel ``(x, y, z)`` in
    ``points``; ``voxels``, optional ``(K,)`` flat indices, restricts
    the result to those voxels (``(R, K)``)."""
    sy = syy = sxy = sx = sxx = None
    n = 0
    for chunk in chunks:
        e = chunk.shape[0]
        flat = chunk.reshape(e, -1)
        x = torch.stack([chunk[:, z, y, xi] for xi, y, z in points]).to(
            torch.float64)
        if sy is None:
            v = flat.shape[1] if voxels is None else int(voxels.numel())
            zeros = dict(dtype=torch.float64, device=flat.device)
            sy, syy = torch.zeros(v, **zeros), torch.zeros(v, **zeros)
            sxy = torch.zeros((len(points), v), **zeros)
            sx = torch.zeros((len(points), 1), **zeros)
            sxx = torch.zeros((len(points), 1), **zeros)
        step = max(1, BLOCK_ELEMENTS // e)
        for s in range(0, sy.shape[0], step):
            cols = slice(s, min(s + step, sy.shape[0]))
            y = flat[:, cols] if voxels is None else flat[:, voxels[cols]]
            y = y.to(torch.float64)
            sy[cols] += y.sum(0)
            syy[cols] += (y * y).sum(0)
            sxy[:, cols] += x @ y
        sx += x.sum(1, keepdim=True)
        sxx += (x * x).sum(1, keepdim=True)
        n += e
    num = n * sxy - sx * sy
    den = torch.sqrt((n * sxx - sx * sx) * (n * syy - sy * sy))
    return num / den


def field(blocks, points, mix: dict, voxels=None) -> torch.Tensor:
    """The measure's reference as the check calls it (``mix`` sets
    nothing for Pearson)."""
    return pearson_fields(blocks, points, voxels)
