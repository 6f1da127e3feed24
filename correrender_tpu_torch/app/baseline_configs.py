"""BASELINE configurations 1-3 on the port.

Counterparts of ``correrender_tpu/app/baseline_configs.py``
(``config1_synth_box_pearson_dvr``, ``config2_rank_correlations``,
``config3_mutual_information``): the same grids, members, measures and,
for config 1, camera, transfer function and image size. Timed with CUDA
events, so each needs a CUDA device and refuses any other. Configs 2
and 3 return their stack, reference series and fields beside the times,
so a caller can check the very fields that were timed.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from correrender_tpu_torch.calculators.correlation import correlate_field
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
