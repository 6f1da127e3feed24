"""Image-quality metrics: MSE, PSNR, SSIM (numpy and scipy).

Counterpart of ``correrender_tpu/utils/metrics.py`` (the reference's
scripts/similarity.py:47-66), without LPIPS, which comes with
ROADMAP A.18.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve1d


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
