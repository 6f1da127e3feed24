"""The program's own zones in the device trace of a ``--trace 1`` run.

The port names its stages with ``utils/profiling.zone``: while the
profiler records, each is a ``user_annotation`` range in the Chrome trace
that ``run.py`` writes (``build/bench_traces/<cell>.json``). CUPTI puts
in the same trace, on the same clock, the CUDA runtime and driver calls
the host makes and the kernels, copies and sets on the card, each device
operation carrying the ``args.correlation`` of the call that launched
it. So a device operation belongs to every program zone that holds its
launching call on the call's own process and thread, the innermost
first.

Only events inside the ``bench.window`` annotation count; device time is
clipped to the window, as in :mod:`benchmark.tracing`. A frame is one
``scene.render_view`` zone that starts inside the window. The trace is
read once a file.
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import defaultdict

from benchmark import spec, tracing

#: Where ``run.py`` writes a cell's trace.
TRACES = spec.ROOT / "build" / "bench_traces"
FRAME = "scene.render_view"
API_CATS = ("cuda_runtime", "cuda_driver")
#: Runtime and driver calls that wait for the card (``cudaMemcpy`` is the
#: synchronous copy; its ``Async`` form does not wait).
SYNC_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cudaMemcpy",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"))
_VERSION = re.compile(r"_v\d+$")


def is_program_zone(event: dict) -> bool:
    """A zone of the program: an annotation that is not the harness's."""
    return (event.get("cat") == "user_annotation"
            and not event["name"].startswith("bench."))


@dataclasses.dataclass
class ProgramTrace:
    """What the window's zones hold, by zone name (a zone counts the work
    of every zone inside it)."""

    zones: dict  # name -> zones that start inside the window
    device_ops: int  # device operations inside the window
    device_us: dict  # name -> device us launched inside the zone
    launches: dict  # name -> device operations launched inside it
    syncs: dict  # name -> calls inside it that wait for the card
    api_us: dict  # name -> host us inside it in runtime or driver calls

    @property
    def frames(self) -> int:
        return self.zones.get(FRAME, 0)

    def per_frame(self, table: dict, zone: str = FRAME):
        """``table[zone]`` over the frames; None where the trace has no
        frame, no zone ``zone`` or no device operation."""
        if not self.frames or not self.zones.get(zone) \
                or not self.device_ops:
            return None
        return table.get(zone, 0) / self.frames


def _enclosing(zones, calls):
    """For each call ``(ts, index)`` of one thread, the names of the zones
    of that thread that hold its start, innermost last. ``zones`` are
    ``(ts, end, name)`` sorted by start, longest first on ties; the zones
    of one thread nest."""
    out, stack, z = {}, [], 0
    for ts, index in sorted(calls):
        while z < len(zones) and zones[z][0] <= ts:
            while stack and stack[-1][1] < zones[z][0]:
                stack.pop()
            stack.append(zones[z])
            z += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[index] = tuple(name for _, end, name in stack if end >= ts)
    return out


def read_doc(doc: dict) -> ProgramTrace | None:
    """The program's zones of a Chrome trace, or None without a window."""
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == tracing.WINDOW]
    if not windows:
        return None
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    zones_by_thread = defaultdict(list)
    counts = defaultdict(int)
    for e in events:
        if is_program_zone(e):
            ts = float(e["ts"])
            zones_by_thread[(e.get("pid"), e.get("tid"))].append(
                (ts, ts + float(e["dur"]), e["name"]))
            if w0 <= ts <= w1:
                counts[e["name"]] += 1
    calls = [e for e in events if e.get("cat") in API_CATS]
    calls_by_thread = defaultdict(list)
    for i, e in enumerate(calls):
        calls_by_thread[(e.get("pid"), e.get("tid"))].append(
            (float(e["ts"]), i))
    chains = {}
    for thread, items in calls_by_thread.items():
        zones = sorted(zones_by_thread.get(thread, ()),
                       key=lambda z: (z[0], -z[1]))
        # A call's zones count only where the zone starts in the window.
        zones = [z for z in zones if w0 <= z[0] <= w1]
        chains.update(_enclosing(zones, items))
    by_corr = {}
    syncs, api = defaultdict(int), defaultdict(list)
    for i, e in enumerate(calls):
        chain = chains.get(i, ())
        names = set(chain)
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr[corr] = chain
        ts = float(e["ts"])
        sync = _VERSION.sub("", e["name"]) in SYNC_CALLS
        for name in names:
            api[name].append((ts, ts + float(e["dur"])))
            syncs[name] += sync
    device_us, launches = defaultdict(float), defaultdict(int)
    device_ops = 0
    for e in events:
        if e.get("cat") not in tracing.DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        s0, e0 = max(s, w0), min(s + d, w1)
        if e0 <= s0:
            continue
        device_ops += 1
        chain = by_corr.get((e.get("args") or {}).get("correlation"), ())
        for name in set(chain):
            device_us[name] += e0 - s0
            launches[name] += 1
    return ProgramTrace(
        zones=dict(counts), device_ops=device_ops,
        device_us=dict(device_us), launches=dict(launches),
        syncs=dict(syncs),
        api_us={k: tracing._union(v)[0] for k, v in api.items()})


_READ: dict = {}


def read(path) -> ProgramTrace | None:
    """:func:`read_doc` of the Chrome trace at ``path``, once a file
    (and again only when the file has changed)."""
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _READ:
        with open(path) as f:
            _READ[key] = read_doc(json.load(f))
    return _READ[key]


def of_run(run) -> ProgramTrace | None:
    """The program's zones in the trace of a traced run (a
    :class:`benchmark.run.TracedRun`), or None where it has none."""
    if run.trace is None or run.cell is None:
        return None
    path = TRACES / f"{run.cell.name}.json"
    return read(path) if path.is_file() else None
