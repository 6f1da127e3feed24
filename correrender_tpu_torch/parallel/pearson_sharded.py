"""Distributed correlation over a mesh: Pearson by all-reduced moments,
every other measure by gathering the member axis.

Counterpart of ``correrender_tpu/parallel/pearson_sharded.py``. With the
member axis sharded over ``members``, each rank sums the raw moments of
its member slice and one ``all_reduce`` over ``members`` combines them:

    r = (n·Σxy − Σx·Σy) / sqrt((n·Σxx − Σx²)(n·Σyy − Σy²))

so five numbers a voxel cross the interconnect instead of the series.
The moments are torch sums and one matrix–vector product in float32
(TF32 pinned off by ``ops.precision.f32_matmul``: it would cost about
3e-4 on r); the field is assembled by ``ops.pearson.pearson_from_sums``.
The other measures all-gather the member axis of the rank's Z-block
(or, after ``reshard_member_to_space``, hold it whole) and call
``correlate_field`` on the block, which launches K1, B7, B8 or B10 on
the card. Binned MI normalizes by global bounds, reduced once across
the ranks.

Every function takes the rank's blocks (``parallel/mesh.py``) and
returns its ``(Zb, Y, X)`` block of the field.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from correrender_tpu_torch.calculators.correlation import (
    correlate_field,
    nan_bounds,
)
from correrender_tpu_torch.ops.pearson import pearson_from_sums
from correrender_tpu_torch.ops.precision import f32_matmul
from correrender_tpu_torch.ops.registry import (
    CorrelationMeasure,
    is_measure_binned_mi,
    measure_from_id,
    split_bounds,
)
from correrender_tpu_torch.parallel.mesh import (
    gather_members,
    whole_mesh_group,
)


def pearson_member_sharded(block: torch.Tensor, ref_block: torch.Tensor,
                           mesh) -> torch.Tensor:
    """Pearson field of ``(Zb, Y, X, Eb)`` blocks sharded
    ``(space, -, -, members)``.

    Args:
      block: the rank's member-stack block (float32 or bfloat16).
      ref_block: the rank's ``(Eb,)`` block of the reference series.
      mesh: a ``(space, members)`` mesh (``parallel.mesh.make_mesh``).

    Returns:
      The rank's ``(Zb, Y, X)`` float32 block of the field, the same on
      every rank of a ``members`` group.
    """
    x = ref_block.to(torch.float32)
    y = block.to(torch.float32)
    eb = y.shape[-1]
    with f32_matmul():
        sum_xy = y.reshape(-1, eb) @ x
    # One all-reduce: [n, Σx, Σxx, Σy…, Σyy…, Σxy…].
    sums = torch.cat([
        torch.stack([torch.tensor(float(eb), device=x.device), x.sum(),
                     (x * x).sum()]),
        y.sum(-1).reshape(-1), (y * y).sum(-1).reshape(-1), sum_xy])
    group = mesh.get_group("members")
    if dist.get_world_size(group) > 1:
        dist.all_reduce(sums, group=group)
    sum_y, sum_yy, sum_xy = sums[3:].reshape(3, -1)
    # n stays a device scalar (an exact integer in float32): no sync.
    r = pearson_from_sums(sums[0], sums[1], sum_y, sum_xy, sums[2], sum_yy)
    return r.reshape(block.shape[:-1])


def _global_bounds(mi_bounds, ref, stack, mesh):
    """Binned MI's ``((rmin, rmax), (qmin, qmax))`` as device scalars:
    the caller's, in either of the registry's forms, or the global
    NaN-ignoring ranges reduced over every rank of the mesh."""
    if mi_bounds is not None:
        return split_bounds(mi_bounds)
    (rlo, rhi), (qlo, qhi) = nan_bounds(ref), nan_bounds(stack)
    lo = torch.stack([rlo, qlo])
    hi = torch.stack([rhi, qhi])
    group = whole_mesh_group(mesh)
    if dist.get_world_size(group) > 1:
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    return ((lo[0], hi[0]), (lo[1], hi[1]))


def correlate_member_sharded(block: torch.Tensor, ref_block: torch.Tensor,
                             mesh, measure="pearson", **kwargs):
    """Correlation field of ``(space, -, -, members)`` blocks under any
    measure.

    Pearson (alone or with ``absolute``) takes the all-reduced moments;
    every other case all-gathers the members of the rank's Z-block and
    runs ``correlate_field`` on it, as the JAX package does.
    """
    m = measure_from_id(measure)
    kwargs = dict(kwargs)
    if m == CorrelationMeasure.PEARSON:
        absolute = bool(kwargs.pop("absolute", False))
        if not kwargs:
            out = pearson_member_sharded(block, ref_block, mesh)
            return out.abs() if absolute else out
        kwargs["absolute"] = absolute
    stack = gather_members(block, mesh)
    ref = gather_members(ref_block, mesh)
    if is_measure_binned_mi(m):
        kwargs["mi_bounds"] = _global_bounds(kwargs.pop("mi_bounds", None),
                                             ref, stack, mesh)
    return correlate_field(stack, ref, m, **kwargs)


def correlate_space_sharded(block: torch.Tensor, ref: torch.Tensor, mesh,
                            measure="pearson", **kwargs):
    """Correlation field of purely space-sharded blocks (member axis
    whole), the layout ``reshard_member_to_space`` gives.

    ``mesh`` is a 1-D ``("space",)`` mesh, or a 2-D one whose ranks hold
    Z row-major over both axes. No collective runs during the compute,
    except binned MI's bounds; ``ref`` is the whole ``(E,)`` series.
    """
    m = measure_from_id(measure)
    kwargs = dict(kwargs)
    if is_measure_binned_mi(m):
        kwargs["mi_bounds"] = _global_bounds(kwargs.pop("mi_bounds", None),
                                             ref, block, mesh)
    return correlate_field(block, ref, m, **kwargs)
