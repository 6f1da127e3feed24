"""Correlation-matrix heat map between field pairs.

Counterpart of ``correrender_tpu/diagrams/matrix.py``. Reference:
src/Renderers/Diagram/CorrelationMatrix/* with Full/Symmetric storage
(src/Calculators/CorrelationMatrix.hpp:35-75). The matrix is computed on
the series' device; the SVG is drawn on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.diagrams.svg import SvgCanvas
from correrender_tpu_torch.ops.registry import correlate


def correlation_matrix(
    series,
    measure: str = "pearson",
    symmetric: bool = True,
    **measure_kw,
) -> torch.Tensor:
    """All-pairs correlation of (F, n) series → (F, F) matrix on the
    series' device (an array becomes a CPU tensor)."""
    s = torch.as_tensor(series)
    mat = correlate(s[:, None, :], s[None, :, :], measure, **measure_kw)
    if symmetric:
        mat = 0.5 * (mat + mat.T)
    return mat


def field_correlation_matrix(volume_data, field_names=None, time=0,
                             measure="pearson", sample_voxels=1024,
                             seed=0, **kw):
    """Whole-field pairwise correlation matrix: flatten each field's
    (voxel, member) values over a common voxel subsample, gathered on
    the volume's device. Returns ``((F, F) tensor, names)``."""
    names = field_names or volume_data.field_names
    rng = np.random.default_rng(seed)
    g = volume_data.grid
    num_voxels = g.xs * g.ys * g.zs
    idx = rng.choice(num_voxels, min(sample_voxels, num_voxels),
                     replace=False)
    idx_t = torch.as_tensor(idx, device=volume_data.device)
    series = []
    for name in names:
        stack = volume_data.get_member_stack(name, time)
        flat = stack.reshape(-1, stack.shape[-1])[idx_t]  # (S, n)
        series.append(flat.reshape(-1))  # voxels×members as one series
    return correlation_matrix(torch.stack(series).float(), measure,
                              **kw), names


def render_matrix_svg(matrix, labels=None, path=None,
                      size: int = 600, colormap="coolwarm") -> str:
    """Heat-map SVG of a correlation matrix (an array or a tensor)."""
    # render.tf imports this package (its colormaps).
    from correrender_tpu_torch.render.tf import TransferFunction

    if isinstance(matrix, torch.Tensor):
        matrix = matrix.cpu().numpy()
    f = len(matrix)
    tf = TransferFunction.from_colormap(colormap, domain=(-1.0, 1.0))
    lut = tf.lut.cpu().numpy()
    margin = 80
    cell = (size - margin) / f
    canvas = SvgCanvas(size, size)
    for i in range(f):
        for j in range(f):
            v = matrix[i, j]
            if not np.isfinite(v):
                color = (0.5, 0.5, 0.5)
            else:
                t = np.clip((v + 1) / 2, 0, 1)
                color = tuple(lut[int(t * 255)][:3])
            canvas.rect(
                margin + j * cell, margin + i * cell, cell - 1, cell - 1,
                fill=color,
            )
    if labels:
        for i, label in enumerate(labels):
            canvas.text(margin + (i + 0.5) * cell, margin - 8, label,
                        size=10, rotate=-45)
            canvas.text(margin - 8, margin + (i + 0.5) * cell, label,
                        size=10, anchor="end")
    if path:
        canvas.save(path)
    return canvas.to_svg()
