"""Synthetic ensembles for tests and the chip smoke run.

:func:`peak_profile`, :func:`synth_box_lambda_field` and
:func:`synth_box_ensemble` are the port's own numpy copies of the JAX
package's generators (``correrender_tpu/utils/fixtures.py``), so tests
hand the same arrays to both packages and the port never imports a
module of the JAX package. :func:`synth_box_stack` is the same
planted-box ensemble drawn on the device from a ``torch.Generator``: the
numpy version draws float64 on the host, about 12.5 GB per temporary at
250³×100.
"""

from __future__ import annotations

import numpy as np
import torch


def peak_profile(dist: np.ndarray) -> np.ndarray:
    """Quartic-ish bump: 1 − max(0, 2|d| − 1)² inside |d| < 1, else 0."""
    inner = np.maximum(0.0, np.abs(dist) * 2.0 - 1.0) ** 2
    return np.where(dist >= 1.0, 0.0, 1.0 - inner)


def _peaks(g):
    """Centre x, centre y and size of the 4×4 layout's ten boxes."""
    return [
        (g, g, 2.0 * g), (7 * g, 7 * g, 2.0 * g),
        (2.5 * g, 0.5 * g, g), (2.5 * g, 1.5 * g, g),
        (5.5 * g, 6.5 * g, g), (5.5 * g, 7.5 * g, g),
        (0.5 * g, 2.5 * g, g), (1.5 * g, 2.5 * g, g),
        (6.5 * g, 5.5 * g, g), (7.5 * g, 5.5 * g, g),
    ]


def synth_box_lambda_field(xs: int = 128, ys: int = 128,
                           zs: int = 32) -> np.ndarray:
    """Correlation-strength field λ(z, y, x) of the 4×4 planted-box
    layout, float64."""
    z, y, x = np.meshgrid(np.arange(zs), np.arange(ys), np.arange(xs),
                          indexing="ij")
    cz = zs // 2
    field = np.zeros((zs, ys, xs))
    for cx, cy, size in _peaks(zs // 2):
        dist = np.maximum.reduce(
            [np.abs(x - cx), np.abs(y - cy), np.abs(z - cz)]) / (size * 0.5)
        field += peak_profile(dist)
    return field


def synth_box_ensemble(xs: int = 32, ys: int = 32, zs: int = 8,
                       members: int = 100, linear: bool = True,
                       seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Ensemble ``(members, zs, ys, xs)`` with planted correlated boxes.

    Each voxel's member series is ``λ·s1 + (1−λ)·s0`` with s0 i.i.d.
    normal from ``np.random.default_rng(seed)`` and s1 a shared linear
    ramp (``linear``) or a sine, so voxels inside a box correlate
    strongly with each other. The stock layout gives only positive λ;
    a negative λ would take the second series (the negated ramp, or a
    cosine).
    """
    lam = synth_box_lambda_field(xs, ys, zs)
    rng = np.random.default_rng(seed)
    if linear:
        s1p = 2.0 * np.linspace(0.0, 1.0, members) - 1.0
        s1n = -s1p
    else:
        s1p = np.sin(np.linspace(0.0, 2.0 * np.pi, members))
        s1n = np.cos(np.linspace(0.0, 2.0 * np.pi, members))
    sign = np.where(lam >= 0.0, 1.0, -1.0)
    lam_abs = np.abs(lam)
    s0 = rng.normal(0.0, 1.0, size=(members, zs, ys, xs))
    s1 = np.where(sign[None] >= 0, s1p[:, None, None, None],
                  s1n[:, None, None, None])
    data = lam_abs[None] * s1 + (1.0 - lam_abs[None]) * s0
    return data.astype(dtype)


def synth_box_lambda_field_torch(xs: int = 128, ys: int = 128, zs: int = 32,
                                 device=None) -> torch.Tensor:
    """:func:`synth_box_lambda_field` computed on ``device`` in float32."""
    z = torch.arange(zs, dtype=torch.float32, device=device)[:, None, None]
    y = torch.arange(ys, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(xs, dtype=torch.float32, device=device)[None, None, :]
    cz = zs // 2
    field = torch.zeros((zs, ys, xs), dtype=torch.float32, device=device)
    for cx, cy, size in _peaks(zs // 2):
        dist = torch.maximum(
            torch.maximum((x - cx).abs(), (y - cy).abs()), (z - cz).abs()
        ) / (size * 0.5)
        inner = torch.clamp_min(dist * 2.0 - 1.0, 0.0) ** 2
        field += torch.where(dist >= 1.0, 0.0, 1.0 - inner)
    return field


def synth_box_stack(xs: int, ys: int, zs: int, members: int,
                    generator: torch.Generator,
                    device=None) -> torch.Tensor:
    """Member-last ``(zs, ys, xs, members)`` float32 planted-box stack
    drawn on ``device``: each series is ``λ·s1 + (1−λ)·s0`` with s0
    i.i.d. normal from ``generator`` and s1 the shared linear ramp
    (:func:`synth_box_ensemble` with ``linear=True``). Built in place:
    the stack is the only full-size allocation."""
    lam = synth_box_lambda_field_torch(xs, ys, zs, device=device)
    s1p = 2.0 * torch.linspace(0.0, 1.0, members, device=device) - 1.0
    stack = torch.randn((zs, ys, xs, members), generator=generator,
                        device=device)
    lam_abs = lam.abs()[..., None]
    sign = torch.where(lam >= 0.0, 1.0, -1.0)[..., None]
    stack.mul_(1.0 - lam_abs).addcmul_(lam_abs * sign, s1p)
    return stack
