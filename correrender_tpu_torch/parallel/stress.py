"""Executed stress runs of the sharded programs at multi-GB stacks.

Counterpart of ``correrender_tpu/parallel/stress.py``, with the same
entry points and the same keys in the dicts they return. Each runs the
production program (``pearson_member_sharded``, the member → space
reshard, ``correlate_space_sharded`` for a rank or kNN measure,
``config5_sharded_batch_render``) over the running process group (a
one-rank group is started if none is), and checks its output against a
reference computed apart from it.

* **The stack.** Each rank draws only its own block, on its device:
  every Z-plane's ``(Y, X, E)`` standard normals come from a
  ``torch.Generator`` seeded with the run's seed and the plane's index,
  and the rank keeps its member block, so the stack depends on the seed
  and not on the rank count (as ``baseline_configs.config5_stack``).
  The JAX package's numpy draw per device shard is not reproduced.
* **The reference.** Pearson's is a float64 Pearson of the rank's block,
  streamed over Z-slabs on the rank's device; the rank and kNN
  measures' is the dense ``correlate_field`` of the same slabs. The
  largest difference is reduced over the ranks.
* **Memory.** The JAX package reads the compiled program's memory
  analysis; here ``compiled_temp_output_bytes_per_device`` is the
  device's peak allocation during the timed call
  (``torch.cuda.max_memory_allocated``), ``None`` on the CPU.

The times are on the host clock with the device synchronized, and
unrounded.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.parallel.mesh import (
    axis_size,
    block_range,
    gather_members,
    make_mesh,
    mesh_device,
    reshard_member_to_space,
)
from correrender_tpu_torch.parallel.pearson_sharded import (
    correlate_space_sharded,
    pearson_member_sharded,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _all_max(value: float, device) -> float:
    """The largest of every rank's ``value``."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    if dist.get_world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _space_sum(value: int, mesh, device) -> int:
    """The sum of ``value`` over the ranks of the ``space`` axis."""
    t = torch.tensor([value], dtype=torch.int64, device=device)
    if axis_size(mesh, "space") > 1:
        dist.all_reduce(t, group=mesh.get_group("space"))
    return int(t.item())


def stack_planes(grid, members: int, z_range, device, dtype=torch.float32,
                 seed: int = 0) -> torch.Tensor:
    """Planes ``z_range`` of a ``grid + (members,)`` standard normal
    stack (``grid`` is ``(Z, Y, X)``): plane z is drawn whole by
    ``torch.randn`` from a generator on ``device`` seeded with
    ``(seed, z)``, then cast to ``dtype``."""
    _, ys, xs = grid
    z0, z1 = z_range
    out = torch.empty((z1 - z0, ys, xs, members), dtype=dtype,
                      device=device)
    for z in range(z0, z1):
        gen = torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + z)
        out[z - z0] = torch.randn((ys, xs, members), generator=gen,
                                  device=device)
    return out


def rank_stack(grid, members: int, mesh, dtype=torch.float32,
               seed: int = 0) -> torch.Tensor:
    """The rank's ``(Zb, Y, X, Eb)`` block of :func:`stack_planes`'
    stack, Z over ``space`` and E over ``members``, on its device."""
    z_range = block_range(grid[0], axis_size(mesh, "space"),
                          mesh.get_local_rank("space"))
    nm = axis_size(mesh, "members")
    if members % nm:
        raise ValueError(f"E={members} not divisible by {nm} member shards")
    eb = members // nm
    e0 = mesh.get_local_rank("members") * eb
    return stack_planes(grid, members, z_range, mesh_device(mesh), dtype,
                        seed)[..., e0:e0 + eb].contiguous()


def _ref_series(members: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((members,), generator=gen, device=device)


def _member_block(ref: torch.Tensor, mesh) -> torch.Tensor:
    eb = ref.shape[0] // axis_size(mesh, "members")
    e0 = mesh.get_local_rank("members") * eb
    return ref[e0:e0 + eb].contiguous()


def _pearson_f64(slab: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Float64 Pearson of ``(z, Y, X, E)`` against ``(E,)``, from the raw
    moments, as the JAX package's streamed reference."""
    x = ref.to(torch.float64)
    y = slab.to(torch.float64)
    n = x.shape[0]
    sx, sxx = x.sum(), (x * x).sum()
    sy = y.sum(-1)
    syy = (y * y).sum(-1)
    sxy = y @ x
    num = n * sxy - sx * sy
    den = torch.sqrt((n * sxx - sx * sx) * (n * syy - sy * sy))
    return (num / den).to(torch.float32)


def _peak_bytes(device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def stress_pearson(grid=(128, 512, 512), members=64, mesh_shape=(2, 4),
                   dtype="bfloat16", check_fraction=0.25,
                   device="cuda") -> dict:
    """Run ``pearson_member_sharded`` on a multi-GB stack and hold it to a
    streamed float64 Pearson on ``check_fraction`` of the 16-plane
    Z-slabs (every ``1 / check_fraction``-th one), the rest unchecked as
    in the JAX package."""
    dev_type = torch.device(device).type
    mesh = make_mesh(*mesh_shape, device_type=dev_type)
    dev = mesh_device(mesh)
    n_dev = dist.get_world_size()
    stack, gen_s = _timed(lambda: rank_stack(grid, members, mesh,
                                             _DTYPES[dtype], seed=10), dev)
    ref = _member_block(_ref_series(members, 11, dev), mesh)
    shard_bytes = stack.numel() * stack.element_size()
    stack_bytes = int(np.prod(grid)) * members * stack.element_size()

    pearson_member_sharded(stack, ref, mesh)  # warm-up
    _reset_peak(dev)
    out, compute_s = _timed(lambda: pearson_member_sharded(stack, ref,
                                                           mesh), dev)
    per_dev = _peak_bytes(dev)

    # The reference needs whole series: a rank gathers its Z-block's
    # members, slab by slab (the ranks of a members group hold the same
    # Z-block, so they gather alike).
    full_ref = gather_members(ref, mesh)
    zstep = max(1, int(round(1.0 / max(check_fraction, 1e-6))))
    max_delta, checked = 0.0, 0
    for z0 in range(0, stack.shape[0], 16 * zstep):
        z1 = min(z0 + 16, stack.shape[0])
        want = _pearson_f64(gather_members(stack[z0:z1], mesh), full_ref)
        finite = torch.isfinite(want)
        delta = (out[z0:z1] - want).abs()[finite]
        if delta.numel():
            max_delta = max(max_delta, float(delta.max()))
        checked += z1 - z0
    return {
        "program": "pearson_member_sharded",
        "grid": list(grid), "members": members, "dtype": str(dtype),
        "devices": n_dev, "mesh": list(mesh_shape),
        "stack_gb": stack_bytes / 2**30,
        "shard_bytes_per_device": shard_bytes,
        "compiled_temp_output_bytes_per_device": per_dev,
        "gen_s": gen_s,
        "compute_s": compute_s,
        "gvox_per_s": float(np.prod(grid)) / compute_s / 1e9,
        "z_slabs_checked": _space_sum(checked, mesh, dev),
        "max_abs_delta_vs_streamed_f64": _all_max(max_delta, dev),
    }


def stress_reshard(grid=(128, 512, 512), members=64, mesh_shape=(2, 4),
                   dtype="bfloat16", device="cuda") -> dict:
    """Run the member → space reshard on a multi-GB stack and check that
    every rank's new block equals the planes it should hold, drawn
    afresh (every member; the JAX package checks the first four)."""
    dev_type = torch.device(device).type
    mesh = make_mesh(*mesh_shape, device_type=dev_type)
    dev = mesh_device(mesh)
    n_dev = dist.get_world_size()
    stack = rank_stack(grid, members, mesh, _DTYPES[dtype], seed=12)
    stack_bytes = int(np.prod(grid)) * members * stack.element_size()

    (resharded, smesh), reshard_s = _timed(
        lambda: reshard_member_to_space(stack, mesh), dev)
    zs, ys, xs = grid
    if tuple(resharded.shape) != (zs // n_dev, ys, xs, members):
        raise AssertionError(
            f"space-sharded block shape {tuple(resharded.shape)}")
    z0, _ = block_range(zs, n_dev, dist.get_rank())
    delta = 0.0
    for z in range(resharded.shape[0]):  # a plane at a time: no 2nd stack
        want = stack_planes(grid, members, (z0 + z, z0 + z + 1), dev,
                            stack.dtype, seed=12)[0]
        delta = max(delta, float((resharded[z].float()
                                  - want.float()).abs().max()))
    return {
        "program": "reshard_member_to_space",
        "grid": list(grid), "members": members, "dtype": str(dtype),
        "devices": n_dev,
        "stack_gb": stack_bytes / 2**30,
        "reshard_s": reshard_s,
        "effective_gb_per_s": stack_bytes / 2**30 / reshard_s,
        "content_max_delta": _all_max(delta, dev),
        "space_mesh_axes": list(smesh.mesh_dim_names),
    }


def stress_rank_ksg(measure="spearman", grid=(32, 256, 256), members=64,
                    device="cuda", **kwargs) -> dict:
    """Run ``correlate_space_sharded`` (the layout after the reshard) for
    a rank or kNN measure and hold it to the dense ``correlate_field``
    on Z-slabs of the same stack.

    Besides JAX's keys, ``timed_launches`` holds the kernel launches of
    the timed call (``ops/cuda/_build.LAUNCHES``; 0 on the CPU)."""
    from correrender_tpu_torch.calculators.correlation import (
        correlate_field,
    )

    dev_type = torch.device(device).type
    mesh = make_mesh(members=1, device_type=dev_type)
    dev = mesh_device(mesh)
    n_dev = dist.get_world_size()
    stack = rank_stack(grid, members, mesh, torch.float32, seed=13)
    stack_space, smesh = reshard_member_to_space(stack, mesh)
    ref = _ref_series(members, 14, dev)

    correlate_space_sharded(stack_space, ref, smesh, measure, **kwargs)
    before = dict(_build.LAUNCHES)
    out, compute_s = _timed(lambda: correlate_space_sharded(
        stack_space, ref, smesh, measure, **kwargs), dev)
    launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                if v != before[k]}

    zb = stack_space.shape[0]
    chunk = max(1, grid[0] // 8)
    max_delta = 0.0
    for z0 in range(0, zb, chunk):
        z1 = min(z0 + chunk, zb)
        want = correlate_field(stack_space[z0:z1], ref, measure, **kwargs)
        finite = torch.isfinite(want)
        delta = (out[z0:z1] - want).abs()[finite]
        if delta.numel():
            max_delta = max(max_delta, float(delta.max()))
    stack_bytes = int(np.prod(grid)) * members * 4
    return {
        "program": f"correlate_space_sharded[{measure}]",
        "grid": list(grid), "members": members,
        "devices": n_dev,
        "stack_gb": stack_bytes / 2**30,
        "compute_s": compute_s,
        "voxels_per_s": float(np.prod(grid)) / compute_s,
        "max_abs_delta_vs_dense": _all_max(max_delta, dev),
        "timed_launches": launches,
    }


def stress_config5(grid=(256, 256, 128), members=64, device="cuda") -> dict:
    """Run config 5's sharded batch-render program (it draws its own
    float32 stack); ``grid`` is ``(X, Y, Z)``, config 5's order."""
    from correrender_tpu_torch.app import baseline_configs as bc

    res = bc.config5_sharded_batch_render(grid=grid, members=members,
                                          device=device)
    row = {k: v for k, v in res.items()
           if k not in ("stack", "field", "ref", "frames", "cameras", "tf",
                        "mesh", "export_path")}
    row["stack_gb"] = int(np.prod(grid)) * members * 4 / 2**30
    return row
