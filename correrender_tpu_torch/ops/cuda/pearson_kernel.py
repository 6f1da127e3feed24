"""K1: the fused Pearson kernel (``csrc/pearson.cu``) and its plain
version.

Counterpart of ``correrender_tpu/ops/pallas/pearson_kernel.py``.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.pearson import pearson_from_sums


def pearson_plain(series: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: ``(V, n)`` series against an
    ``(n,)`` reference → ``(V,)`` f32, with Σx and Σx² hoisted."""
    n = series.shape[-1]
    return pearson_from_sums(
        n,
        ref.sum(),
        series.sum(-1),
        (series * ref).sum(-1),
        (ref * ref).sum(),
        (series * series).sum(-1),
    )


def pearson_cuda(stack: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Pearson field of a member-last stack against one reference series.

    Args:
      stack: ``(..., n)`` float32 member series, contiguous.
      ref: ``(n,)`` float32 reference series on the same device.

    Returns:
      ``(...)`` float32 correlation field. A CPU tensor takes
      :func:`pearson_plain`; a CUDA tensor launches K1, which streams a
      16-byte aligned stack of up to 2048 members in tiles and reads any
      other (an offset view, more members) one warp a voxel.
    """
    n = stack.shape[-1]
    lead = stack.shape[:-1]
    if stack.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError("pearson_cuda takes float32 stack and ref")
    if tuple(ref.shape) != (n,):
        raise ValueError(f"ref has shape {tuple(ref.shape)}, expected ({n},)")
    if ref.device != stack.device:
        raise ValueError("stack and ref must lie on one device")
    if stack.device.type == "cpu":
        return pearson_plain(stack.reshape(-1, n), ref).reshape(lead)
    if stack.device.type != "cuda":
        raise ValueError(f"no Pearson kernel for device {stack.device}")
    _build.require_cuda_tensor(stack, "stack", torch.float32, stack.device)
    _build.require_cuda_tensor(ref, "ref", torch.float32, stack.device)
    series = stack.reshape(-1, n)  # a view: the stack is contiguous
    out = torch.empty(series.shape[0], dtype=torch.float32,
                      device=stack.device)
    if series.shape[0] == 0:
        return out.reshape(lead)
    lib = _build.library()
    _build.LAUNCHES["pearson"] += 1
    err = lib.correrender_pearson(
        series.data_ptr(), ref.data_ptr(), out.data_ptr(), series.shape[0], n,
        stack.device.index, _build.stream_of(stack),
    )
    _build.check(err, "pearson")
    return out.reshape(lead)
