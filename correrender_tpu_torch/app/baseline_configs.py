"""BASELINE configuration 1 on the port.

Counterpart of ``correrender_tpu/app/baseline_configs.py::
config1_synth_box_pearson_dvr``: the same grid, members, camera,
transfer function and image size. Timed with CUDA events, so it needs a
CUDA device; it refuses any other.
"""

from __future__ import annotations

import torch

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


def config1_synth_box_pearson_dvr(grid=(128, 128, 32), members=100,
                                  device="cuda", seed=0):
    """Pearson field + DVR on the planted-box synthetic ensemble, drawn
    on the device from ``seed``.

    Renders once to warm up (the first call also builds the kernels),
    then times one frame for a moved reference point.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("config 1 is timed with CUDA events: pass a "
                         f"CUDA device, not {device}")
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
