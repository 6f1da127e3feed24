"""The device trace of a ``--trace 1`` run, read back from its file.

``torch.profiler`` records the first part of the window (CPU and CUDA
activity) under a ``bench.window`` annotation; the Chrome trace it
writes holds only that part. From it come the device's busy seconds
(the union of kernel, copy and set intervals inside the window), each
kernel's launches, the operations that took most device time, and the
device's idle gaps named by the innermost host operation running at
their midpoint.
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list  # (name, start_us, duration_us), inside the window
    device_ops: list  # [[name, seconds], ...], at most 10
    idle_gaps: list  # [[host activity, seconds], ...], at most 10

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name matches
        the regular expression."""
        rx = re.compile(pattern)
        hits = [d for name, _, d in self.kernels if rx.search(name)]
        return sum(hits) * 1e-6, len(hits)


def short_name(name: str, width: int = 96) -> str:
    name = re.sub(r"^void ", "", name)
    name = name.split("(", 1)[0] if not name.startswith("(") else name
    return name[:width]


def _union(intervals):
    """Total length and the gaps of sorted ``(start, end)`` intervals."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def read(path) -> Trace:
    with open(path) as f:
        doc = json.load(f)
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in events
               if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not windows:
        raise ValueError(f"{path}: no {WINDOW} annotation in the trace")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device, kernels = [], []
    per_op = defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        s0, e0 = max(s, w0), min(s + d, w1)
        if e0 <= s0:
            continue
        device.append((s0, e0))
        per_op[short_name(e["name"])] += e0 - s0
        if e["cat"] == "kernel":
            kernels.append((e["name"], s, d))
    busy, gaps = _union(device)
    if device:  # the window's edges before the first and after the last
        first = min(s for s, _ in device)
        last = max(e for _, e in device)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    else:
        gaps = [(w0, w1)]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and e["name"] != WINDOW)
    idle = defaultdict(float)
    active, nxt = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        inner = min(active, key=lambda h: h[1] - h[0], default=None)
        label = inner[2] if inner else "host outside any operation"
        idle[short_name(label)] += (g1 - g0) * 1e-6
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    return Trace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, kernels=kernels,
        device_ops=[[name, us * 1e-6] for name, us in top],
        idle_gaps=sorted(([k, v] for k, v in idle.items()),
                         key=lambda kv: -kv[1])[:10])
