"""Halo exchange for Z-sharded volumes, and the sharded Gaussian blur.

Counterpart of ``correrender_tpu/parallel/halo.py``. With a volume's Z
axis block-sharded over a mesh axis, a spatial stencil needs each
block's boundary planes from its neighbours: two ring shifts by
``batch_isend_irecv`` bring them. Edge blocks clamp (the reference's
clamp-to-edge), so the stencil sees what it would see on the whole
volume.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from correrender_tpu_torch.calculators.noise import (
    gaussian_blur_3d,
    gaussian_kernel_1d,
)
from correrender_tpu_torch.parallel.mesh import axis_size


def _neighbour(mesh, axis_name: str, step: int) -> int:
    """The global rank ``step`` places along ``axis_name``."""
    coord = list(mesh.get_coordinate())
    coord[mesh.mesh_dim_names.index(axis_name)] += step
    return int(mesh.mesh[tuple(coord)])


def exchange_halo_z(block: torch.Tensor, halo: int, mesh,
                    axis_name: str = "space") -> torch.Tensor:
    """Pad the rank's ``(Zb, Y, X, ...)`` block with ``halo`` planes from
    its neighbours along the Z-sharded mesh axis; the first and last
    blocks repeat their own edge plane.

    Raises ``ValueError`` on every rank when a halo exceeds the smallest
    block of the axis (one hop supplies at most a neighbour's block).
    """
    if halo <= 0:
        raise ValueError(f"halo must be positive, got {halo}")
    group = mesh.get_group(axis_name)
    n, idx = axis_size(mesh, axis_name), mesh.get_local_rank(axis_name)
    zb = torch.tensor([block.shape[0]], device=block.device)
    if n > 1:
        dist.all_reduce(zb, op=dist.ReduceOp.MIN, group=group)
    zmin = int(zb.item())
    if halo > zmin:
        raise ValueError(
            f"halo {halo} exceeds the per-shard Z extent {zmin}; use fewer "
            "shards (or a smaller stencil) so each shard holds at least "
            "one full halo of planes")
    lo = block[:1].expand((halo,) + tuple(block.shape[1:]))
    hi = block[-1:].expand((halo,) + tuple(block.shape[1:]))
    ops = []
    if idx > 0:  # exchange with the previous block
        lo = torch.empty_like(lo)
        prev = _neighbour(mesh, axis_name, -1)
        ops += [dist.P2POp(dist.isend, block[:halo].contiguous(), prev,
                           group=group),
                dist.P2POp(dist.irecv, lo, prev, group=group)]
    if idx < n - 1:  # and with the next
        hi = torch.empty_like(hi)
        nxt = _neighbour(mesh, axis_name, 1)
        ops += [dist.P2POp(dist.isend, block[-halo:].contiguous(), nxt,
                           group=group),
                dist.P2POp(dist.irecv, hi, nxt, group=group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([lo, block, hi])


def make_sharded_stencil(fn, mesh, halo: int, axis_name: str = "space"):
    """Wrap a ``(Z, Y, X) → (Z, Y, X)`` stencil to run on the rank's
    Z-block: ``fn(block_with_halo, *extra)`` is applied to the
    halo-padded block and the halo planes are cropped from its result."""
    if halo <= 0:
        raise ValueError(f"halo must be positive, got {halo}")

    def local(block, *extra):
        out = fn(exchange_halo_z(block, halo, mesh, axis_name), *extra)
        return out[halo:-halo]

    return local


def gaussian_blur_3d_sharded(block: torch.Tensor, sigma: float, mesh):
    """Z-sharded Gaussian blur with halo exchange: the rank's block of
    ``calculators.noise.gaussian_blur_3d`` of the whole volume."""
    halo = len(gaussian_kernel_1d(sigma)) // 2
    fn = make_sharded_stencil(lambda b: gaussian_blur_3d(b, sigma), mesh,
                              halo)
    return fn(block)
