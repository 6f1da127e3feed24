"""Run one cell of ``BENCHMARK.json`` on the GPU and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up draws the cell's data on the card from ``--seed``, builds the
program (the kernel library is built once a checkout, into
``build/kernels/``) and runs the warm-up interactions. The window then
runs one closed-loop user for ``--seconds``: each interaction is sent
once the last one's result is ready on the card, or, where the cell's
settings give ``ahead_s``, while the card holds at most that many
seconds of work sent and not done. With ``--trace 0`` the
result holds the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of the window's
first part (``build/bench_traces/<cell>.json``) and from spans around
the program's calls in the rest, with the trace's breakdown. A fixed
probe of the host's CPU (``host.py``) runs 5 times just before the
window opens and 5 times once it has closed; its median goes to
standard error in every run, and is ``host_probe_ms`` with ``--trace 1``.

Once the window has closed, the kept outputs are held to the plain
references (``check.py``) and the last line of standard output is the
result: ``{"correct", "attempted", "failed", "metrics", "device",
["breakdown",] "check"}``. The run exits non-zero and prints no result
without a CUDA device, with fewer devices than the cell asks for, or
when JAX or the JAX package has been loaded: after the window, and
again just before the result is printed (after every metric's reader
and the check have loaded what they load).
"""

from __future__ import annotations

import time

_T_TOP = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names that must not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "correrender_tpu")
#: Seconds at the start of a ``--trace 1`` window that the profiler
#: records (at most half the window).
TRACE_SECONDS = 3.0
#: Calls of the host probe (``host.py``) just before the window opens and
#: again once it has closed.
PROBES = 5


def _process_age() -> float:
    """Seconds since this process started, from ``/proc`` (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_TOP = _process_age()


def _caches_in_checkout() -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths (the kernel library's own is ``build/kernels/``)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class TracedRun:
    """What the per-layer readers read: the cell, the spans, the traced
    window's interactions (``actions``, each with the ``camera`` in
    effect), the device trace and the host probe's milliseconds."""

    def __init__(self, cell, spans: dict, actions: list, trace,
                 host_probe_ms=()):
        self.cell, self.spans = cell, spans
        self.actions, self.trace = actions, trace
        self.host_probe_ms = list(host_probe_ms)

    def span_mean(self, name: str):
        values = self.spans.get(name)
        return sum(values) / len(values) if values else None

    def roofline(self, kernel: str, pattern: str, shapes: list):
        """100 × the least time of ``kernel``'s launches of ``shapes``
        (``bounds/<kernel>.py``) over the device time of the traced
        kernels matching ``pattern``."""
        if self.trace is None or not shapes:
            return None
        seconds, launches = self.trace.kernel_seconds(pattern)
        if not launches or seconds <= 0:
            return None
        from benchmark import spec
        bound = spec.load_module("bounds", kernel)
        least = sum(bound.least(s)[0] for s in shapes)
        return 100.0 * least / seconds


def _percentile(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))


#: The same numbers under the names that cells whose frames wait on the
#: host's CPU report them by, with bounds of their own.
HOSTPACED = {"hostpaced_ms_p95": "interaction_ms_p95",
             "hostpaced_frames_per_s": "frames_per_s"}


def end_to_end(name: str, window: dict) -> float:
    name = HOSTPACED.get(name, name)
    if name == "interaction_ms_p95":
        return _percentile(window["latency_ms"], 95)
    if name == "frames_per_s":
        return window["completed"] / window["seconds"]
    if name == "field_gvox_per_s":
        return window["completed"] * window["voxels"] / window["seconds"] \
            / 1e9
    if name == "setup_s":
        return window["setup_s"]
    raise KeyError(f"no end-to-end metric {name!r}")


class Window:
    """The measured window: the interactions, their latencies and the
    outputs kept for the check."""

    def __init__(self, driver, actions, keep: set, device,
                 ahead_s: float = 0.0):
        from benchmark.drivers import stamps, sync

        self.driver, self.actions, self.keep = driver, actions, keep
        self.ahead_s = ahead_s
        self.stamps = lambda: stamps(device, 2)
        self.sync = lambda: sync(device)
        self.latency_ms, self.kept, self.traced = [], [], []
        self.completed = 0
        self.last = None

    def _record(self, action, out, index):
        point = action["point"] if "point" in action else self.driver.point
        item = {"point": tuple(point),
                "camera": getattr(self.driver, "camera", None),
                "field": out.get("field"), "frame": out.get("frame")}
        if index in self.keep:
            self.kept.append({k: (v.clone() if hasattr(v, "clone") else v)
                              for k, v in item.items()})
        self.last = item

    def timed(self, until: float, count: int = 0) -> None:
        """Interactions until the host clock passes ``until`` and at least
        ``count`` have been sent, each timed by CUDA events from its start
        to its result on the card. With ``ahead_s``, interactions are sent
        while those in flight hold at most that many seconds of the card's
        work (by the median of the last 16 latencies), and the window ends
        once every one sent is done: the card stays fed while the host
        stands still, and a latency is the card's time for its
        interaction. Else each is sent once the last one's result is
        ready."""
        flight = collections.deque()
        while time.perf_counter() < until or self.completed < count:
            action = next(self.actions)
            start, end = self.stamps()
            start.record()
            out = self.driver.interact(action)
            end.record()
            flight.append((start, end))
            self._record(action, out, self.completed)
            self.completed += 1
            while len(flight) > self._depth():
                self._done(flight.popleft(), wait=True)
        self.sync()
        while flight:
            self._done(flight.popleft(), wait=False)

    def _depth(self) -> int:
        """How many interactions may be in flight."""
        if not self.ahead_s or not self.latency_ms:
            return 0
        recent = statistics.median(self.latency_ms[-16:])
        return max(1, int(self.ahead_s * 1e3 / max(recent, 1e-3)))

    def _done(self, events, wait: bool) -> None:
        """Wait for an interaction sent earlier and keep its latency."""
        start, end = events
        if wait and self.ahead_s:
            end.synchronize()
        elif wait:
            self.sync()
        self.latency_ms.append(start.elapsed_time(end))

    def profiled(self, until: float) -> None:
        from torch.profiler import record_function

        while time.perf_counter() < until:
            action = next(self.actions)
            with record_function("bench.interaction"):
                out = self.driver.interact(action)
            with record_function("bench.sync"):
                self.sync()
            self.traced.append(dict(
                action, camera=getattr(self.driver, "camera", None)))
            self._record(action, out, self.completed)
            self.completed += 1

    def spans(self, until: float, spans: dict, count: int = 3) -> None:
        """Interactions with spans until ``until``, at least ``count``."""
        done = self.completed + count
        while time.perf_counter() < until or self.completed < done:
            action = next(self.actions)
            out = self.driver.interact_spans(action, spans)
            self.sync()
            self._record(action, out, self.completed)
            self.completed += 1

    def finish(self) -> None:
        """Keep the last interaction's output too (nothing ran after it)."""
        if self.last is not None and (self.completed - 1) not in self.keep:
            self.kept.append(self.last)
        self.last = None


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             driver_kwargs=None):
    """Set-up, window and check of one cell on ``device``; returns the
    result dict, or None when a forbidden module was loaded."""
    import torch

    from benchmark import check, drivers, host, spec, traffic, tracing

    check.references(cell)
    t_driver = time.perf_counter()
    driver = drivers.make(cell.config, cell.traffic, seed, device,
                          **(driver_kwargs or {}))
    grid_xyz = driver.grid_xyz
    chk = cell.settings["check"]
    keep = set(traffic.check_sample(seed, int(chk["interactions"]),
                                    int(chk["within"])))
    window = Window(driver, traffic.interactions(cell.traffic, grid_xyz,
                                                 seed), keep, device,
                    float(cell.settings.get("ahead_s", 0.0)))
    window.sync()
    t_ready = time.perf_counter()
    setup_s = _AGE_AT_TOP + (t_ready - _T_TOP)
    probe_ms = host.probe_ms(PROBES)
    t0 = time.perf_counter()
    spans, traced = {}, None
    if not trace:
        window.timed(t0 + seconds)
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        path = ROOT / "build" / "bench_traces" / f"{cell.name}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()  # the profiler's start is not timed
            with record_function(tracing.WINDOW):
                window.profiled(t0 + min(TRACE_SECONDS, seconds / 2))
        prof.export_chrome_trace(str(path))
        del prof
        window.spans(t0 + seconds, spans)
    elapsed = time.perf_counter() - t0
    probe_ms += host.probe_ms(PROBES)
    window.finish()
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return None
    if trace:
        traced = tracing.read(path)
    # The program's state is freed before the references run.
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = check.readings(cell, driver, window.kept, seed)
    t_check = time.perf_counter() - t_check
    correct, report = check.verdict(cell, values)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window.completed,
              "failed": 0}
    metrics = {}
    if not trace:
        measured = {"latency_ms": window.latency_ms,
                    "completed": window.completed, "seconds": elapsed,
                    "voxels": grid_xyz[0] * grid_xyz[1] * grid_xyz[2],
                    "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(m["name"], measured),
                                  "unit": m["unit"]}
    else:
        run_data = TracedRun(cell, spans, window.traced, traced, probe_ms)
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(run_data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.device_ops,
                               "idle_gaps": traced.idle_gaps}
    result["metrics"] = metrics
    result["device"] = device_info
    result["check"] = report
    print(f"set-up: {_AGE_AT_TOP:.3f} s to the harness's first line, "
          f"{t_driver - _T_TOP:.3f} s of imports and the device, "
          f"{t_ready - t_driver:.3f} s of data, program and warm-up",
          file=sys.stderr)
    print(f"host probe: median {host.median(probe_ms)!r} ms of "
          f"{len(probe_ms)} (before the window "
          f"{', '.join(f'{v:.3f}' for v in probe_ms[:PROBES])}; after "
          f"{', '.join(f'{v:.3f}' for v in probe_ms[PROBES:])})",
          file=sys.stderr)
    lat = sorted(window.latency_ms) or [float("nan")]
    print(f"{cell.name} seed {seed}: {window.completed} interactions in "
          f"{elapsed:.3f} s, set-up {setup_s:.3f} s, peak "
          f"{peak / 2**30:.2f} GiB, check {t_check:.3f} s; latency ms "
          f"min {lat[0]:.3f} median "
          f"{lat[len(lat) // 2]:.3f} max {lat[-1]:.3f}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    _caches_in_checkout()
    import torch

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the GPU only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device)
    if result is None:
        return 3
    result["device"]["power"] = _power_limit()
    print(f"card: {result['device']['power']}", file=sys.stderr)
    return emit(result)


def emit(result: dict) -> int:
    """Print the compared numbers beside their limits (last on standard
    error) and the result line, unless a forbidden module has been
    loaded by now: then name it and print no result."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, r in result["check"].items():
        print(f"check {name} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    return args


if __name__ == "__main__":
    sys.exit(main())
