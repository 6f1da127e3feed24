"""B1: one-pass Pearson moments of a member-major chunk
(``csrc/moments.cu``) and its plain version.

Counterpart of ``correrender_tpu/ops/pallas/moments_kernel.py``. A
streaming caller holds the member stack as member-major ``(E, Z, Y, X)``
chunks and accumulates ``Σy, Σy², Σxy`` per voxel over them
(``calculators/correlation.py::pearson_streamed``). Semantics as in the
JAX package: float32 sums, a bfloat16 chunk upcast on read. The TPU
kernel's block rules (``V`` a multiple of the voxel tile, ``E`` of 8)
are not carried over, so :func:`chunk_moments` needs no pad copy.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.cuda import _build

_DTYPES = (torch.float32, torch.bfloat16)


def chunk_moments_plain(flat: torch.Tensor, ref_chunk: torch.Tensor,
                        acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of B1: ``(3, V)`` float32 ``(Σy, Σy², Σxy)`` of an
    ``(E, V)`` chunk against ``ref_chunk``, summed member after member in
    the kernel's order; with ``acc``, the sums are added to it in place
    (one rounding each) and ``acc`` is returned."""
    m = torch.zeros((3, flat.shape[1]), dtype=torch.float32,
                    device=flat.device)
    for e in range(flat.shape[0]):
        y = flat[e].to(torch.float32)
        m[0] += y
        m[1] += y * y
        m[2] += ref_chunk[e] * y
    return m if acc is None else acc.add_(m)


def _check(flat, ref_chunk, acc):
    if flat.dim() != 2 or flat.dtype not in _DTYPES:
        raise TypeError("chunk_moments_flat takes an (E, V) float32 or "
                        f"bfloat16 chunk, got {tuple(flat.shape)} {flat.dtype}")
    e, v = flat.shape
    if ref_chunk.dtype != torch.float32 or tuple(ref_chunk.shape) != (e,):
        raise ValueError(f"ref_chunk must be ({e},) float32")
    if ref_chunk.device != flat.device:
        raise ValueError("chunk and ref_chunk must lie on one device")
    if acc is not None and (acc.dtype != torch.float32
                            or tuple(acc.shape) != (3, v)
                            or acc.device != flat.device):
        raise ValueError(f"acc must be (3, {v}) float32 on the chunk's device")


def chunk_moments_flat(flat: torch.Tensor, ref_chunk: torch.Tensor,
                       acc: torch.Tensor | None = None) -> torch.Tensor:
    """Moments of an ``(E, V)`` member-major chunk in one read of it.

    Args:
      flat: ``(E, V)`` float32 or bfloat16 chunk, any ``E`` and ``V``.
      ref_chunk: ``(E,)`` float32 slice of the reference series.
      acc: optional ``(3, V)`` float32 running sums; the chunk's sums are
        added to them in place (``acc + Σ_chunk``, one rounding each)
        and ``acc`` is returned.

    Returns:
      ``(3, V)`` float32 ``(Σy, Σy², Σxy)``. A CPU chunk takes
      :func:`chunk_moments_plain`; a CUDA chunk launches B1.
    """
    _check(flat, ref_chunk, acc)
    dev = flat.device
    if dev.type == "cpu":
        return chunk_moments_plain(flat, ref_chunk, acc)
    if dev.type != "cuda":
        raise ValueError(f"no moments kernel for device {dev}")
    _build.require_cuda_tensor(flat, "chunk", flat.dtype, dev)
    _build.require_cuda_tensor(ref_chunk, "ref_chunk", torch.float32, dev)
    e, v = flat.shape
    out = acc
    if out is None:
        out = torch.empty((3, v), dtype=torch.float32, device=dev)
    else:
        _build.require_cuda_tensor(acc, "acc", torch.float32, dev)
    if v == 0:
        return out
    lib = _build.library()
    _build.LAUNCHES["chunk_moments"] += 1
    err = lib.correrender_chunk_moments(
        flat.data_ptr(), int(flat.dtype == torch.bfloat16),
        ref_chunk.data_ptr(), None if acc is None else acc.data_ptr(),
        out.data_ptr(), v, e, dev.index, _build.stream_of(out))
    _build.check(err, "chunk_moments")
    return out


def chunk_moments(chunk: torch.Tensor, ref_chunk: torch.Tensor):
    """``(Σy, Σy², Σxy)`` of one ``(E, Z, Y, X)`` member chunk (float32
    or bfloat16), each ``(Z, Y, X)`` float32, in one read of the chunk."""
    spatial = chunk.shape[1:]
    out = chunk_moments_flat(chunk.reshape(chunk.shape[0], -1), ref_chunk)
    return tuple(out[i].reshape(spatial) for i in range(3))
