"""Binned (histogram) mutual information over the member axis.

Counterpart of ``correrender_tpu/ops/mi_binned.py`` (reference
``computeMutualInformationBinned``, MutualInformation.cpp:45-143):

* inputs are normalized to [0, 1] by the caller;
* bin index = clamp(int(v · B), 0, B-1); non-finite pairs are skipped;
* MI = H(x) + H(y) − H(x,y), dropping probabilities at or below 0.5/n
  (marginals) and 0.5/n² (joint).

The joint histogram is the one-hot product ``one_hot(bx)ᵀ · one_hot(by)``
batched over voxels (``torch.einsum``). The JAX package has no kernel
for this measure either: it measured its Pallas kernel slower than the
XLA product.
"""

from __future__ import annotations

import torch


def mutual_information_binned(x: torch.Tensor, y: torch.Tensor,
                              num_bins: int = 80,
                              dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Binned MI between ``x`` and ``y`` (both in [0, 1]) along the last
    axis, in nats, as ``(...)`` float32."""
    x, y = torch.broadcast_tensors(x, y)
    n = x.shape[-1]
    b = num_bins
    ok = torch.isfinite(x) & torch.isfinite(y)
    # Masked pairs are zeroed before the int cast (NaN has no int value);
    # their one-hot rows are dropped below.
    bx = torch.clamp((torch.where(ok, x, 0.0) * b).to(torch.int64), 0, b - 1)
    by = torch.clamp((torch.where(ok, y, 0.0) * b).to(torch.int64), 0, b - 1)
    okd = ok[..., None].to(dtype)
    ox = torch.nn.functional.one_hot(bx, b).to(dtype) * okd
    oy = torch.nn.functional.one_hot(by, b).to(dtype) * okd
    joint = torch.einsum("...ni,...nj->...ij", ox, oy)
    total = joint.sum((-2, -1), keepdim=True)
    p_xy = joint / total
    p_x = p_xy.sum(-1)
    p_y = p_xy.sum(-2)
    eps1 = 0.5 / n
    eps2 = 0.5 / (n * n)
    zero = torch.zeros((), dtype=p_xy.dtype, device=p_xy.device)
    h_x = -torch.where(p_x > eps1, p_x * torch.log(p_x), zero).sum(-1)
    h_y = -torch.where(p_y > eps1, p_y * torch.log(p_y), zero).sum(-1)
    h_xy = -torch.where(p_xy > eps2, p_xy * torch.log(p_xy), zero).sum(
        (-2, -1))
    return (h_x + h_y - h_xy).to(torch.float32)


def binned_mi_correlation_coefficient(mi: torch.Tensor) -> torch.Tensor:
    """Linfoot's informational correlation coefficient
    sqrt(1 − exp(−2·MI)) (reference CorrelationCalculator.cpp:1071-1072)."""
    return torch.sqrt(torch.clamp(1.0 - torch.exp(-2.0 * mi), min=0.0))
