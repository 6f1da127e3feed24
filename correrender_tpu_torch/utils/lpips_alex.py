"""LPIPS (AlexNet variant): the published architecture in torch.

Counterpart of ``correrender_tpu/utils/lpips_alex.py``: the perceptual
metric of the reference's evaluation scripts (scripts/similarity.py:47-62,
``lpips.LPIPS(net='alex')``): the AlexNet feature stack, the input
scaling, per-layer unit normalization, the linear heads and the spatial
mean. The convolutions and pools are ``F.conv2d`` and ``F.max_pool2d``
(JAX computes them with ``lax.conv``, outside any Pallas kernel), run
with cuDNN's TF32 off (``ops/precision.f32_conv``).

Weights are not shipped (they need a download). The loader takes the
official files converted once (torchvision ``alexnet*.pth`` and the lpips
``alex.pth`` heads, read without torch's unpickler by
``io/torchscript.py``) as an ``.npz``, found via ``path``,
``$CORRERENDER_LPIPS_WEIGHTS`` or ``~/.cache/correrender_tpu/lpips_alex.npz``,
the same files the JAX package reads. :func:`synthetic_lpips_params`
builds the same deterministic weights as the JAX package (numpy
``default_rng``), which the tests and ``tests/goldens/lpips_golden.json``
pin the forward with.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from correrender_tpu_torch.ops.precision import f32_conv

# torchvision AlexNet feature stack: (out, kernel, stride, padding),
# with 3x3/2 max-pools after stages 0 and 1. Taps after each ReLU.
_ALEX_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
# LPIPS input scaling layer constants (lpips/lpips.py ScalingLayer).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _const(v: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, device=like.device).reshape(1, -1, 1, 1)


@f32_conv()
def alexnet_features(x: torch.Tensor, params: dict) -> list:
    """Five ReLU-tap feature maps of the AlexNet ``features`` stack.

    Args:
      x: ``(N, 3, H, W)`` in [-1, 1] (the LPIPS convention), on the
        weights' device.
      params: dict with ``conv{i}.weight``/``bias`` (OIHW, (O,)) tensors.
    """
    x = (x - _const(_SHIFT, x)) / _const(_SCALE, x)
    taps = []
    for i, (_, _, stride, pad) in enumerate(_ALEX_CONVS):
        x = F.conv2d(x, params[f"conv{i}.weight"], params[f"conv{i}.bias"],
                     stride=stride, padding=pad)
        x = torch.clamp_min(x, 0.0)
        taps.append(x)
        if i < 2:
            x = F.max_pool2d(x, 3, 2)
    return taps


def lpips_alex(a, b, params: dict) -> float:
    """LPIPS distance between two images with AlexNet features.

    Args:
      a, b: ``(H, W, 3)`` float images in [0, 1] (RGBA alpha is dropped;
        a 2-D image is gray), host arrays or tensors.
      params: weight dict from :func:`load_lpips_weights`; the distance
        is computed on its device.
    """
    device = params["conv0.weight"].device

    def prep(img):
        arr = torch.as_tensor(np.asarray(img, np.float32), device=device)
        if arr.ndim == 2:
            arr = torch.stack([arr] * 3, dim=-1)
        return arr[..., :3].permute(2, 0, 1)[None] * 2.0 - 1.0

    with torch.no_grad():
        fa = alexnet_features(prep(a), params)
        fb = alexnet_features(prep(b), params)
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / torch.sqrt((xa * xa).sum(dim=1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt((xb * xb).sum(dim=1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2
            lin = params[f"lin{i}.weight"].reshape(1, -1, 1, 1)
            total = total + (d * lin).sum(dim=1).mean()
    return float(total)


def _from_torch_dicts(alex_weights: dict, lin_weights: dict) -> dict:
    """Map torchvision-alexnet + lpips-linear state dicts onto ours."""
    # torchvision features indices of the conv layers
    conv_idx = (0, 3, 6, 8, 10)
    params = {}
    for i, idx in enumerate(conv_idx):
        for kind in ("weight", "bias"):
            for key in (f"features.{idx}.{kind}", f"{idx}.{kind}",
                        f"net.slice{i + 1}.{idx}.{kind}"):
                if key in alex_weights:
                    params[f"conv{i}.{kind}"] = np.asarray(
                        alex_weights[key], np.float32)
                    break
        if f"conv{i}.weight" not in params:
            raise ValueError(f"alexnet weights: conv layer {idx} missing")
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                    f"lin{i}.weight"):
            if key in lin_weights:
                params[f"lin{i}.weight"] = np.asarray(lin_weights[key],
                                                      np.float32)
                break
        if f"lin{i}.weight" not in params:
            raise ValueError(f"lpips linear head {i} missing")
    return params


def convert_lpips_weights(alexnet_path: str, lpips_path: str,
                          out_npz: str) -> dict:
    """One-time conversion: official .pth files → combined .npz."""
    from correrender_tpu_torch.io.torchscript import read_torch_weights

    params = _from_torch_dicts(read_torch_weights(alexnet_path),
                               read_torch_weights(lpips_path))
    np.savez(out_npz, **params)
    return params


def synthetic_lpips_params(seed: int = 0) -> dict:
    """Deterministic random weights in the published layout, as numpy
    arrays: the JAX package's function, so both packages (and the golden
    generator ``tools/gen_lpips_golden.py``) build the same weights.
    He-scaled so activations stay O(1) through the five stages."""
    rng = np.random.default_rng(seed)
    params = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(_ALEX_CONVS):
        fan_in = in_ch * k * k
        params[f"conv{i}.weight"] = (
            rng.standard_normal((out_ch, in_ch, k, k))
            * np.sqrt(2.0 / fan_in)).astype(np.float32)
        params[f"conv{i}.bias"] = (
            0.1 * rng.standard_normal(out_ch)).astype(np.float32)
        in_ch = out_ch
    for i, ch in enumerate(c for c, *_ in _ALEX_CONVS):
        # lpips heads are non-negative in the published checkpoint.
        params[f"lin{i}.weight"] = np.abs(
            rng.standard_normal((1, ch, 1, 1)) / ch).astype(np.float32)
    return params


def params_to_device(params: dict, device="cuda") -> dict:
    """A weight dict of host arrays as float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


_WEIGHTS_CACHE: dict = {}


def load_lpips_weights(path: str | None = None, device="cuda") -> dict | None:
    """Locate and load LPIPS weights onto ``device``; None when none are
    found.

    Search order: ``path`` → ``$CORRERENDER_LPIPS_WEIGHTS`` →
    ``~/.cache/correrender_tpu/lpips_alex.npz``. Loaded weights are
    memoized per resolved path and device, so a metric loop reads and
    uploads the AlexNet stack once.
    """
    candidates = [
        path,
        os.environ.get("CORRERENDER_LPIPS_WEIGHTS"),
        os.path.expanduser("~/.cache/correrender_tpu/lpips_alex.npz"),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            key = (os.path.abspath(cand), str(torch.device(device)))
            if key not in _WEIGHTS_CACHE:
                with np.load(cand) as data:
                    _WEIGHTS_CACHE[key] = params_to_device(
                        {k: data[k] for k in data.files}, device)
            return _WEIGHTS_CACHE[key]
    return None
