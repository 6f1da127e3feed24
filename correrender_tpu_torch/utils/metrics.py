"""Image-quality metrics: MSE, PSNR, SSIM (numpy and scipy) and LPIPS
(torch).

Counterpart of ``correrender_tpu/utils/metrics.py`` (the reference's
scripts/similarity.py:47-66, comparing ground-truth and approximate
renders). LPIPS uses the published weights when a converted file is
found, else the ``lpips`` package, else the deterministic random-feature
variant LPIPS-R, whose weights are the JAX package's
``jax.random.normal`` draws bit for bit (``ops/noise.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import convolve1d

from correrender_tpu_torch.ops import noise
from correrender_tpu_torch.ops.precision import f32_conv


def mse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / m))


def _gaussian_window(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Structural similarity (Wang et al. 2004), Gaussian-windowed,
    channel-averaged for RGB(A) input."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        return float(
            np.mean([ssim(a[..., c], b[..., c], data_range)
                     for c in range(a.shape[-1])])
        )
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_window()

    def filt(img):
        out = convolve1d(img, win, axis=0, mode="reflect")
        return convolve1d(out, win, axis=1, mode="reflect")

    mu_a = filt(a)
    mu_b = filt(b)
    var_a = filt(a * a) - mu_a**2
    var_b = filt(b * b) - mu_b**2
    cov = filt(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def lpips(a, b, net: str = "alex", device="cuda") -> float:
    """LPIPS perceptual distance (scripts/similarity.py:47-62 role).

    Resolution order, as in the JAX package:

    1. the AlexNet-LPIPS forward (``utils/lpips_alex.py``) with the
       official weights, when a converted weight file is found;
    2. the ``lpips`` package, if installed;
    3. :func:`lpips_random`: a fixed-seed random-feature variant whose
       absolute scale is not comparable to published LPIPS values
       (ordering only).
    """
    if net == "alex":
        from correrender_tpu_torch.utils.lpips_alex import (
            load_lpips_weights,
            lpips_alex,
        )

        weights = load_lpips_weights(device=device)
        if weights is not None:
            return lpips_alex(a, b, weights)
    try:
        import lpips as lpips_pkg
    except ImportError:
        return lpips_random(a, b, device=device)
    model = lpips_pkg.LPIPS(net=net).to(device)

    def prep(img):
        arr = np.moveaxis(np.asarray(img, np.float32), -1, 0)[None]
        return torch.from_numpy(arr * 2 - 1).to(device)

    with torch.no_grad():
        return float(model(prep(a), prep(b)).item())


_LPIPS_CHANNELS = (16, 32, 64, 128, 128)


def _lpips_random_params() -> list:
    """LPIPS-R's HWIO filters: ``jax.random.normal`` of the keys
    ``jax.random.split(jax.random.key(0), 5)``, each scaled by
    ``2 / sqrt(9 · cin)`` in float32, as host arrays."""
    keys = noise.split_like_jax(0, len(_LPIPS_CHANNELS))
    params = []
    cin = 3
    for key, cout in zip(keys, _LPIPS_CHANNELS):
        w = noise.normal_like_jax(key, (3, 3, cin, cout))
        params.append(w * np.float32(2.0 / np.sqrt(9 * cin)))
        cin = cout
    return params


def _same_pad_stride2(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``SAME`` padding of a 3×3 stride-2 convolution, padded
    explicitly (torch's ``padding="same"`` refuses stride 2): per axis
    ``total = max((ceil(n/2) − 1)·2 + 3 − n, 0)``, ``total // 2`` before
    and the rest after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad lists the last axis first
        total = max((math.ceil(n / 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def lpips_random(a, b, device="cuda") -> float:
    """Deterministic random-feature perceptual distance (LPIPS-R).

    A fixed-seed 5-stage stride-2 convolution stack extracts multi-scale
    features; the per-stage unit-normalized feature differences are
    averaged: the LPIPS formula with random (untrained) filters.
    """
    def prep(img):
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        arr = arr[..., :3]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        x = torch.as_tensor(arr, device=device).permute(2, 0, 1)[None]
        return x * 2.0 - 1.0  # NCHW in [-1, 1]

    xa, xb = prep(a), prep(b)
    total = 0.0
    with torch.no_grad(), f32_conv():
        for w in _lpips_random_params():
            w = torch.as_tensor(w, device=device).permute(3, 2, 0, 1)
            xa = torch.clamp_min(F.conv2d(_same_pad_stride2(xa), w,
                                          stride=2), 0.0)
            xb = torch.clamp_min(F.conv2d(_same_pad_stride2(xb), w,
                                          stride=2), 0.0)
            na = xa / torch.clamp_min(
                torch.linalg.vector_norm(xa, dim=1, keepdim=True), 1e-8)
            nb = xb / torch.clamp_min(
                torch.linalg.vector_norm(xb, dim=1, keepdim=True), 1e-8)
            total += float(((na - nb) ** 2).sum(dim=1).mean())
    return total / len(_LPIPS_CHANNELS)


def compare_images(a, b, data_range: float = 1.0, device="cuda") -> dict:
    """All metrics at once (similarity.py's output); LPIPS on
    ``device``."""
    return {
        "mse": mse(a, b),
        "psnr": psnr(a, b, data_range),
        "ssim": ssim(a, b, data_range),
        "lpips": lpips(a, b, device=device),
    }
