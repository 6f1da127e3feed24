"""Automatic performance measurement: state sweeps with CSV output.

Counterpart of ``correrender_tpu/app/perf.py`` (the reference's
src/Utils/AutomaticPerformanceMeasurer.{hpp,cpp}, its --perf mode):
each state (renderer × resolution × field) is rendered headlessly over a
camera orbit, each frame timed on the host clock after a synchronize of
the frame's device, with the cache's bytes and misses and the device's
allocated memory beside it.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import time

import numpy as np
import torch

from correrender_tpu_torch.render.camera import orbit_camera


@dataclasses.dataclass
class PerfState:
    """One sweep state (the reference's InternalState.hpp:128-199)."""

    name: str
    renderer: str = "dvr"
    image_size: tuple = (1920, 1080)
    field: str | None = None
    num_frames: int = 16
    settings: dict = dataclasses.field(default_factory=dict)
    # Memory-pressure mode: the rendered field cycles round-robin per
    # frame, so a cache budget smaller than the field set forces
    # evictions mid-sweep.
    cycle_fields: tuple = ()


def _sync(img: torch.Tensor) -> None:
    if img.is_cuda:
        torch.cuda.synchronize(img.device)


def _device_memory_mib(device: torch.device):
    """Device memory allocated by torch (the reference's VRAM column,
    AutomaticPerformanceMeasurer.hpp:84); None on the CPU."""
    if device.type != "cuda":
        return None
    return round(torch.cuda.memory_allocated(device) / 2**20, 1)


def default_perf_states(full: bool = False, fields=None):
    """The reference's state matrix, renderer × resolution (× field)
    (InternalState.cpp:39-110). The full tier includes 4K, the
    reference's discrete-GPU default (InternalState.cpp:42-55)."""
    sizes = ([(3840, 2160), (1920, 1080), (1280, 720), (640, 480)] if full
             else [(640, 480)])
    renderers = ["dvr", "iso_ray", "domain_outline", "slice"]
    states = []
    for field in (fields or [None]):
        for r in renderers:
            for (w, h) in sizes:
                suffix = f"_{field}" if field else ""
                states.append(PerfState(
                    f"{r}_{w}x{h}{suffix}", renderer=r, image_size=(w, h),
                    field=field, num_frames=16 if full else 8))
    if fields and len(fields) > 1:
        # Cycling the rendered field each frame churns the field cache
        # (evictions when the budget is below the set's total).
        states.append(PerfState(
            "dvr_field_cycle", renderer="dvr", image_size=sizes[-1],
            field=fields[0], num_frames=max(2 * len(fields), 8),
            cycle_fields=tuple(fields)))
    return states


def run_perf_sweep(scene, states, csv_path=None):
    """Render each state over a camera orbit; returns row dicts."""
    rows = []
    device = scene.volume_data.device
    for state in states:
        scene.renderers = []
        scene.add_renderer(
            state.renderer, view=0,
            **({"field": state.field} if state.field else {}),
            **state.settings)
        cache = scene.volume_data.cache
        misses_before = cache.misses
        frame_times = []
        for i in range(state.num_frames):
            theta = 2.0 * math.pi * i / state.num_frames
            scene.views[0] = orbit_camera(theta, 0.3, radius=0.85)
            if state.cycle_fields:
                cyc = state.cycle_fields[i % len(state.cycle_fields)]
                scene.renderers[0]["field"] = cyc
            t0 = time.perf_counter()
            img = scene.render_view(0, image_size=state.image_size)
            _sync(img)
            frame_times.append((time.perf_counter() - t0) * 1000.0)
        arr = np.asarray(frame_times[1:] or frame_times)  # drop warm-up
        rows.append({
            "state": state.name,
            "renderer": state.renderer,
            "width": state.image_size[0],
            "height": state.image_size[1],
            "frames": state.num_frames,
            "time_avg_ms": round(float(arr.mean()), 3),
            "time_median_ms": round(float(np.median(arr)), 3),
            "time_min_ms": round(float(arr.min()), 3),
            "time_max_ms": round(float(arr.max()), 3),
            "cache_used_mib": round(cache.used_bytes / 2**20, 1),
            "cache_misses": cache.misses - misses_before,
            "device_mem_mib": _device_memory_mib(device),
        })
    if csv_path:
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    return rows
