"""Special functions shared by the KSG estimators and their kernels.

Counterpart of ``correrender_tpu/ops/pallas/common.py``
(``digamma_vpu``, ``select_kth``). The port keeps its own copy. The same
series runs as a ``__device__`` function in ``ops/cuda/csrc/
ksg_common.cuh``, so a kernel and its plain version evaluate ψ alike.
"""

from __future__ import annotations

import torch


def digamma_series(x: torch.Tensor) -> torch.Tensor:
    """ψ(x) for x ≥ 1: shift by 8 with the recurrence, then the
    asymptotic series (|error| < 1e-9, far inside float32)."""
    shifted = x + 8.0
    acc = torch.zeros_like(x)
    for i in range(8):
        acc = acc + 1.0 / (x + float(i))
    inv = 1.0 / shifted
    inv2 = inv * inv
    return (torch.log(shifted) - 0.5 * inv
            - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))
            - acc)


def select_kth(d: torch.Tensor, k: int, dim: int = -1) -> torch.Tensor:
    """The (k+1)-th smallest value along ``dim``, self and ties included:
    the order statistic of the multiset (``select_kth`` in the JAX
    package). ``d`` needs at least k+1 entries along ``dim``."""
    return torch.topk(d, k + 1, dim=dim, largest=False).values.select(dim, k)
