"""Profiling and tracing hooks.

Counterpart of ``correrender_tpu/utils/profiling.py`` (the reference's
Tracy zones and GPU timers): named zones that appear in a
``torch.profiler`` trace and add their wall time to a registry for
:func:`timing_summary`, and :func:`trace`, which writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_TIMINGS: dict[str, list] = defaultdict(list)


def sync(x):
    """Wait for the device work behind ``x`` (a tensor, or a list, tuple
    or dict holding tensors) and return ``x``."""
    stack = [x]
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            if item.is_cuda:
                torch.cuda.synchronize(item.device)
            return x
        if isinstance(item, dict):
            stack.extend(reversed(list(item.values())))
        elif isinstance(item, (list, tuple)):
            stack.extend(reversed(item))
    return x


@contextlib.contextmanager
def zone(name: str):
    """Named timing zone (a Tracy zone's role): a ``record_function``
    range in a profiler trace, its wall time kept for
    :func:`timing_summary`."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _TIMINGS[name].append(time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region on the host and, where present, the card, and
    write its Chrome trace (Perfetto) to ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timing_summary(reset: bool = True) -> dict:
    """Aggregated zone timings in milliseconds."""
    out = {}
    for name, samples in _TIMINGS.items():
        arr = sorted(samples)
        out[name] = {
            "count": len(arr),
            "total_ms": sum(arr) * 1e3,
            "mean_ms": sum(arr) / len(arr) * 1e3,
            "median_ms": arr[len(arr) // 2] * 1e3,
        }
    if reset:
        _TIMINGS.clear()
    return out
