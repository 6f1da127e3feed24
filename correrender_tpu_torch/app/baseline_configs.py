"""BASELINE configurations 1-5 on the port.

Counterparts of ``correrender_tpu/app/baseline_configs.py``
(``config1_synth_box_pearson_dvr``, ``config2_rank_correlations``,
``config3_mutual_information``, ``config4_timelag_zarr_flythrough``,
``config5_sharded_batch_render``): the same grids, members, measures
and, for configs 1, 4 and 5, cameras, transfer function and image
sizes. Configs 1-3 are timed with CUDA events, so each needs a CUDA
device and refuses any other. Configs 2 and 3 return their stack,
reference series and fields beside the times, so a caller can check the
very fields that were timed. Configs 4 and 5 time on the host clock,
synchronizing the card first, and run on the CPU too. :func:`run_all`
runs the five in order and writes their rows as JSON.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import tempfile
import time
import zlib

import numpy as np
import torch

from correrender_tpu_torch.calculators.correlation import correlate_field
from correrender_tpu_torch.native import BUILD_ROOT
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.render.pipeline import render_correlation_fast
from correrender_tpu_torch.render.tf import TransferFunction
from correrender_tpu_torch.utils.fixtures import synth_box_stack


def config1_camera() -> Camera:
    return Camera(position=(0.05, 0.3, 0.85))


def config1_transfer_function(device=None) -> TransferFunction:
    return TransferFunction.from_colormap(
        "coolwarm", domain=(-1, 1),
        opacity_points=((0.0, 0.8), (0.5, 0.0), (1.0, 0.8)),
        device=device,
    )


def _cuda_device(device, config: str) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{config} is timed with CUDA events: pass a "
                         f"CUDA device, not {device}")
    return device


def _timed_fields(stack, ref, measures, reps: int = 5) -> dict:
    """Each measure's ``correlate_field`` after a warm-up call, timed
    ``reps`` times with CUDA events: ``{"fields": {measure: field},
    measure + "_ms": median ms, ...}``."""
    out = {"fields": {}}
    for measure in measures:
        out["fields"][measure] = correlate_field(stack, ref, measure)
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            correlate_field(stack, ref, measure)
            end.record()
            torch.cuda.synchronize(stack.device)
            times.append(start.elapsed_time(end))
        out[f"{measure}_ms"] = statistics.median(times)
    return out


def config1_synth_box_pearson_dvr(grid=(128, 128, 32), members=100,
                                  device="cuda", seed=0):
    """Pearson field + DVR on the planted-box synthetic ensemble, drawn
    on the device from ``seed``.

    Renders once to warm up (the first call also builds the kernels),
    then times one frame for a moved reference point.
    """
    device = _cuda_device(device, "config 1")
    xs, ys, zs = grid
    gen = torch.Generator(device=device).manual_seed(seed)
    stack = synth_box_stack(xs, ys, zs, members, gen, device)
    cam = config1_camera()
    tf = config1_transfer_function(device)
    render_correlation_fast(
        stack, (xs // 2, ys // 2, zs // 2), cam, tf, "pearson",
        image_size=(1280, 720),
    )
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    img = render_correlation_fast(
        stack, (xs // 4, ys // 4, zs // 2), cam, tf, "pearson",
        image_size=(1280, 720),
    )
    end.record()
    torch.cuda.synchronize(device)
    return {
        "config": "synth_box_pearson_dvr",
        "grid": list(grid),
        "members": members,
        "device": torch.cuda.get_device_name(device),
        "fused_field_plus_render_ms": start.elapsed_time(end),
        "image": img,
    }


def karman_stack(grid=(96, 64, 32), members=250) -> np.ndarray:
    """Config 2's vortex-street-like ensemble ``(Z, Y, X, members)``:
    advected oscillating vortices with a member phase plus noise, drawn
    from numpy's ``default_rng(0)`` exactly as the JAX package draws it."""
    xs, ys, zs = grid
    z, y, x = np.meshgrid(np.linspace(0, 1, zs), np.linspace(0, 1, ys),
                          np.linspace(0, 1, xs), indexing="ij")
    rng = np.random.default_rng(0)
    phases = rng.uniform(0, 2 * np.pi, members)
    return np.stack(
        [np.sin(12 * x - 3 * p) * np.cos(8 * y + p)
         + 0.3 * rng.normal(size=x.shape) for p in phases],
        axis=-1,
    ).astype(np.float32)


def config2_rank_correlations(grid=(96, 64, 32), members=250,
                              device="cuda"):
    """Spearman and Kendall fields on config 2's ensemble
    (:func:`karman_stack`), each the median of 5 timed calls after a
    warm-up call. The result holds the ``stack``, the ``ref`` series and
    the ``fields`` it timed."""
    device = _cuda_device(device, "config 2")
    xs, ys, zs = grid
    stack = torch.from_numpy(karman_stack(grid, members)).to(device)
    ref = stack[zs // 2, ys // 2, xs // 4]
    out = {"config": "rank_correlations", "grid": list(grid),
           "members": members, "device": torch.cuda.get_device_name(device),
           "stack": stack, "ref": ref}
    out.update(_timed_fields(stack, ref, ("spearman", "kendall")))
    for measure in ("spearman", "kendall"):
        out[f"{measure}_voxels_per_s"] = (xs * ys * zs
                                          / (out[f"{measure}_ms"] / 1e3))
    return out


def config3_mutual_information(grid=(48, 48, 24), members=500,
                               device="cuda", seed=0):
    """Binned and KSG MI fields on a standard normal stack, each the
    median of 5 timed calls after a warm-up call. The result holds the
    ``stack``, the ``ref`` series and the ``fields`` it timed.

    The stack is drawn on the device by a ``torch.Generator`` seeded
    with ``seed``; the JAX package draws it with ``jax.random.normal``,
    so the two packages' data differ (same distribution, same
    measures)."""
    device = _cuda_device(device, "config 3")
    xs, ys, zs = grid
    gen = torch.Generator(device=device).manual_seed(seed)
    stack = torch.randn((zs, ys, xs, members), generator=gen, device=device)
    ref = stack[zs // 2, ys // 2, xs // 2]
    out = {"config": "mutual_information", "grid": list(grid),
           "members": members, "device": torch.cuda.get_device_name(device),
           "stack": stack, "ref": ref}
    timed = _timed_fields(stack, ref, ("mi_binned", "mi_kraskov"))
    out["fields"] = timed["fields"]
    for measure, key in (("mi_binned", "binned"), ("mi_kraskov", "ksg")):
        out[f"{key}_ms"] = timed[f"{measure}_ms"]
        out[f"{key}_voxels_per_s"] = xs * ys * zs / (out[f"{key}_ms"] / 1e3)
    return out


def write_zarr_array(path, data: np.ndarray, chunks, compressor="zlib"):
    """Write ``data`` as a Zarr v2 array directory (C order, chunks
    zero-padded at the edges): zlib-compressed, as the JAX package's
    config 4 writes it, or raw with ``compressor=None``."""
    os.makedirs(path, exist_ok=True)
    meta = {
        "zarr_format": 2,
        "shape": list(data.shape),
        "chunks": list(chunks),
        "dtype": data.dtype.str,
        "compressor": {"id": compressor} if compressor else None,
        "fill_value": 0,
        "order": "C",
        "filters": None,
    }
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    grids = [range(-(-s // c)) for s, c in zip(data.shape, chunks)]
    for idx in itertools.product(*grids):
        sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
        chunk = data[sl]
        chunk = np.pad(chunk, [(0, c - s) for c, s in zip(chunks,
                                                           chunk.shape)])
        raw = chunk.tobytes()
        with open(os.path.join(path, ".".join(str(i) for i in idx)),
                  "wb") as f:
            f.write(zlib.compress(raw) if compressor else raw)


def config4_ensemble() -> np.ndarray:
    """Config 4's time-dependent ensemble ``(E=6, T=8, Z=12, Y=24,
    X=24)``, drawn from numpy's ``default_rng(1)`` exactly as the JAX
    package draws it."""
    rng = np.random.default_rng(1)
    base = rng.normal(size=(8, 12, 24, 24)).astype(np.float32)
    return np.stack(
        [np.roll(base, e, axis=0) + 0.1 * rng.normal(size=base.shape)
         for e in range(6)]
    ).astype(np.float32)


def config4_timelag_zarr_flythrough(tmp_dir=None, device="cuda"):
    """Time-lag correlation on a Zarr ensemble and an animated DVR
    flythrough: the ensemble (:func:`config4_ensemble`) written as a
    zlib Zarr store, loaded on ``device``, a time-mode Pearson
    calculator with ``time_lag=2`` at (12, 12, 6), and ``orbit_path(4)``
    at 320×240 stepping the time, once to warm up and once timed.

    Returns the timings (host clock; the card is synchronized before each
    reading) beside the ``scene``, its ``cameras`` and ``times``, and the
    PNG ``frames`` of the timed pass, so a caller can render the same
    frames again."""
    from correrender_tpu_torch.app.camera_path import (
        orbit_path,
        render_flythrough,
    )
    from correrender_tpu_torch.app.state import Scene
    from correrender_tpu_torch.calculators.correlation import (
        CorrelationCalculator,
    )
    from correrender_tpu_torch.io import load_volume

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    tmp_dir = tmp_dir or tempfile.mkdtemp()
    store = os.path.join(tmp_dir, "ens.zarr")
    data = config4_ensemble()
    write_zarr_array(os.path.join(store, "q"), data, (2, 4, 12, 24, 24))

    vd = load_volume(store, device=device)
    scene = Scene(vd)
    calc = CorrelationCalculator(
        field_name="q", measure="pearson", reference_point=(12, 12, 6),
        ensemble_mode=False, time_lag=2)
    name = scene.add_calculator(calc)
    scene.add_renderer("dvr", field=name)
    times = list(range(vd.grid.ts - 2))
    cameras = orbit_path(4)
    passes = {}
    for label in ("warm", "fly"):
        sync()
        t0 = time.perf_counter()
        frames = render_flythrough(scene, cameras,
                                   os.path.join(tmp_dir, label),
                                   image_size=(320, 240), time_indices=times)
        sync()
        passes[label] = (time.perf_counter() - t0) * 1e3
    return {
        "config": "timelag_zarr_flythrough",
        "zarr_shape": list(data.shape),
        "device": str(device),
        "frames": frames,
        "compile_pass_ms": passes["warm"],
        "total_ms": passes["fly"],
        "ms_per_frame": passes["fly"] / len(frames),
        "scene": scene,
        "cameras": cameras,
        "times": times,
    }


def config5_stack(grid, members: int, z_range, device) -> torch.Tensor:
    """Planes ``z_range`` of config 5's ``(Z, Y, X, E)`` standard normal
    stack (``grid`` is ``(X, Y, Z)``): each plane drawn by ``torch.randn``
    from a generator on ``device`` seeded with its plane index, so a rank
    draws only its own block and the stack does not depend on the rank
    count. (The JAX package draws ``jax.random.normal(key(2))``, which is
    not reproduced.)"""
    xs, ys, _ = grid
    planes = []
    for z in range(*z_range):
        gen = torch.Generator(device=device).manual_seed(2_000 + z)
        planes.append(torch.randn((ys, xs, members), generator=gen,
                                  device=device))
    if not planes:
        return torch.empty((0, ys, xs, members), device=device)
    return torch.stack(planes)


def config5_sharded_batch_render(grid=None, members=64, device="cuda",
                                 tmp_dir=None):
    """Sharded Pearson field, a batch of four sharded shear-warp renders
    and a NetCDF export, on a ``(ranks, 1)`` mesh over the running
    process group (a one-rank group is started if none is).

    ``grid`` is ``(X, Y, Z)``; by default ``(256, 256, 128)`` on the card
    (the JAX package's size on an accelerator) and ``(64, 64, 32)``
    elsewhere. Each rank draws its Z-block of the stack
    (:func:`config5_stack`); the reference series is numpy's
    ``default_rng(3)`` draw, as in JAX. The field is timed on its second
    call, the batch (four cameras at 1280×720, intermediate scale 0.5,
    as in JAX) on its second pass, on the host clock with the card
    synchronized.
    The gathered field is written by rank 0 to ``tmp_dir/field.nc``.

    Returns JAX's keys (the times unrounded) beside the rank's ``stack``
    and ``field`` blocks, ``ref``, the ``frames`` and ``cameras`` of the
    timed pass, the transfer function ``tf``, the ``mesh`` and the
    ``export_path``.
    """
    import torch.distributed as dist

    from correrender_tpu_torch.io import writers
    from correrender_tpu_torch.parallel.dvr_sharded import (
        dvr_shearwarp_sharded,
    )
    from correrender_tpu_torch.parallel.mesh import (
        block_range,
        gather_z,
        make_mesh,
    )
    from correrender_tpu_torch.parallel.pearson_sharded import (
        pearson_member_sharded,
    )

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if grid is None:
        side = 256 if device.type == "cuda" else 64
        grid = (side, side, side // 2)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    mesh = make_mesh(members=1, device_type=device.type)
    n_ranks = dist.get_world_size()
    z_range = block_range(grid[2], n_ranks, mesh.get_local_rank("space"))
    stack = config5_stack(grid, members, z_range, device)
    ref = torch.as_tensor(np.random.default_rng(3).normal(
        size=members).astype(np.float32), device=device)
    pearson_member_sharded(stack, ref, mesh)
    field, corr_ms = timed(lambda: pearson_member_sharded(stack, ref, mesh))

    tf = TransferFunction.from_colormap("coolwarm", domain=(-1, 1),
                                        device=device)
    cameras = [Camera(position=(0.05 + 0.1 * k, 0.2, 0.9)) for k in range(4)]

    def batch():
        return [dvr_shearwarp_sharded(field, cam, tf, mesh,
                                      image_size=(1280, 720),
                                      intermediate_scale=0.5)
                for cam in cameras]

    batch()  # warm-up pass, as in JAX
    frames, render_ms = timed(batch)

    whole = gather_z(field, mesh).cpu().numpy()
    shared = [tmp_dir or (tempfile.mkdtemp() if dist.get_rank() == 0
                          else None)]
    dist.broadcast_object_list(shared, src=0)
    export = os.path.join(shared[0], "field.nc")
    if dist.get_rank() == 0:
        writers.write_netcdf(export, whole, name="pearson")
    dist.barrier()
    return {
        "config": "sharded_batch_render_export",
        "grid": list(grid),
        "members": members,
        "devices": n_ranks,
        "sharded_pearson_ms": corr_ms,
        "batch_renders": len(cameras),
        "batch_render_total_ms": render_ms,
        "export_bytes": os.path.getsize(export),
        "note": ("one rank a device; the same sharded program at any rank "
                 "count"),
        "stack": stack,
        "ref": ref,
        "field": field,
        "frames": frames,
        "cameras": cameras,
        "tf": tf,
        "mesh": mesh,
        "export_path": export,
    }


#: Where :func:`run_all` writes by default: under the checkout's build/,
#: never the root's BASELINE_RESULTS.json (the JAX package's record).
RESULTS_PATH = BUILD_ROOT / "baseline" / "BASELINE_RESULTS.json"


def _jsonable(value) -> bool:
    try:
        json.dumps(value)
    except (TypeError, ValueError):
        return False
    return True


def run_all(output_path=None, device="cuda"):
    """Run BASELINE configs 1-5 in order on ``device``, as the JAX
    package's ``run_all`` does: a config that raises gives the row
    ``{"config": <function name>, "error": "<type>: <message>"}`` and the
    loop goes on; each row gets its ``wall_s`` (host clock, unrounded)
    and is printed as one JSON line; the list is written to
    ``output_path`` (default :data:`RESULTS_PATH`) and returned.

    The configs return tensors, scenes and frames beside their numbers;
    a row keeps only the values JSON can hold. Configs 4 and 5 write
    their files (the Zarr store and PNG frames, the NetCDF export) into
    ``config4/`` and ``config5/`` beside ``output_path``. Config 5 reuses
    a running process group (a one-rank group is started if none is)."""
    output_path = os.path.abspath(
        RESULTS_PATH if output_path is None else output_path)
    out_dir = os.path.dirname(output_path)
    results = []
    for fn, kwargs in (
        (config1_synth_box_pearson_dvr, {}),
        (config2_rank_correlations, {}),
        (config3_mutual_information, {}),
        (config4_timelag_zarr_flythrough,
         {"tmp_dir": os.path.join(out_dir, "config4")}),
        (config5_sharded_batch_render,
         {"tmp_dir": os.path.join(out_dir, "config5")}),
    ):
        for path in kwargs.values():
            os.makedirs(path, exist_ok=True)
        t0 = time.perf_counter()
        try:
            out = fn(device=device, **kwargs)
            row = {k: v for k, v in out.items() if _jsonable(v)}
            del out
        except Exception as e:  # record, keep going
            row = {"config": fn.__name__,
                   "error": f"{type(e).__name__}: {e}"}
        row["wall_s"] = time.perf_counter() - t0
        results.append(row)
        print(json.dumps(row))
    os.makedirs(out_dir, exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(results, f, indent=2)
    return results
