"""Synthetic ensembles for tests and the chip smoke run.

The numpy generators of ``correrender_tpu.utils.fixtures`` (numpy-only)
are re-exported for tests, which hand the same arrays to both packages.
They are imported on first access, so the port's own paths never load a
module of the JAX package. :func:`synth_box_stack` is the same
planted-box ensemble drawn on the device from a ``torch.Generator``: the
numpy version draws float64 on the host, about 12.5 GB per temporary at
250³×100.
"""

from __future__ import annotations

import torch

_REEXPORTED = ("peak_profile", "synth_box_ensemble", "synth_box_lambda_field")


def __getattr__(name):
    if name in _REEXPORTED:
        from correrender_tpu.utils import fixtures

        return getattr(fixtures, name)
    raise AttributeError(name)


def synth_box_lambda_field_torch(xs: int = 128, ys: int = 128, zs: int = 32,
                                 device=None) -> torch.Tensor:
    """:func:`synth_box_lambda_field` computed on ``device`` in float32."""
    g = zs // 2
    peaks = [
        (g, g, 2.0 * g), (7 * g, 7 * g, 2.0 * g),
        (2.5 * g, 0.5 * g, g), (2.5 * g, 1.5 * g, g),
        (5.5 * g, 6.5 * g, g), (5.5 * g, 7.5 * g, g),
        (0.5 * g, 2.5 * g, g), (1.5 * g, 2.5 * g, g),
        (6.5 * g, 5.5 * g, g), (7.5 * g, 5.5 * g, g),
    ]
    z = torch.arange(zs, dtype=torch.float32, device=device)[:, None, None]
    y = torch.arange(ys, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(xs, dtype=torch.float32, device=device)[None, None, :]
    cz = zs // 2
    field = torch.zeros((zs, ys, xs), dtype=torch.float32, device=device)
    for cx, cy, size in peaks:
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
