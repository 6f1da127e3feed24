"""Precision pins for torch products on the card."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_matmul():
    """Run with TF32 matmuls off, then restore the caller's setting.

    TF32 rounds a product's float32 inputs to 10 mantissa bits (about
    1e-3 relative), where the JAX package's products are float32, and
    lets cuBLAS pick another kernel and summation order. Pinning plain
    f32 keeps a result independent of a process-wide ``allow_tf32``
    that a caller set for its own work. Usable as a decorator.
    """
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def f32_conv():
    """Run with cuDNN's TF32 convolutions off, then restore the caller's
    setting.

    ``torch.backends.cudnn.allow_tf32`` is True by default, so a float32
    convolution on the card rounds its inputs to 10 mantissa bits, where
    the JAX package's ``lax.conv`` is float32 (LPIPS distances then drift
    about 1e-3 relative). Usable as a decorator.
    """
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved
