"""Profiling and tracing hooks.

Counterpart of ``correrender_tpu/utils/profiling.py`` (the reference's
Tracy zones and GPU timers): :func:`zone` names a stage of the program in
a ``torch.profiler`` trace, and :func:`trace` writes such a trace.

The zones are read from the trace, never from a timer of their own: the
profiler records each open zone as a ``user_annotation`` range on the
host, and CUPTI records the runtime calls made inside it and the kernels,
copies and sets those calls launch, on the same clock and linked by their
correlation ids. A zone's device time is then the device time of the
work launched inside it, which a reader of the trace sums (the
benchmark's ``program_trace.py``). The zones of the port:

- ``scene.render_view``: ``Scene.render_view``, one frame of a view;
- ``field.compute``: ``VolumeData.get_field`` on a cache miss, the
  provider (a calculator's field);
- ``field.streamed``: ``pearson_streamed``, B1 over the chunks, then
  the assembly;
- ``render.dvr``: one ``dvr`` renderer of the Scene, its field ready;
- ``render.layout``: the Scene's shear-warp layout built on a cache miss
  (the classification, K2);
- ``dvr.exact``: a ``dvr`` renderer's exact marcher (B5);
- ``dvr.composite``: ``dvr_shearwarp``'s geometry and composite (K3);
- ``dvr.warp``: ``dvr_shearwarp``'s warp to the screen;
- ``viewer.frame``, ``viewer.overlay``, ``viewer.encode``: the viewer's
  render (the device work, the quantize and the copy to the host), its
  host overlays and its PNG encode.
"""

from __future__ import annotations

import contextlib
import os

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
#: What :func:`zone` returns while no profiler records: one shared
#: context that does nothing.
_IDLE = contextlib.nullcontext()


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


def zone(name: str):
    """A named stage of the program (a Tracy zone's role), as a context
    manager: ``with zone("dvr.warp"): ...``.

    While a profiler records, the zone is a ``record_function(name)``
    range, a ``user_annotation`` in the profiler's Chrome trace beside
    the kernels that the work inside it launches. Otherwise it is one
    shared no-op context: the profiler's flag is read once on entry, and
    nothing is recorded, kept or allocated. The zone records no CUDA
    event and never waits for the device; its device time is read from
    the trace (see the module docstring).
    """
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _IDLE


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
