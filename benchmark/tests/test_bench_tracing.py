"""Reading a Chrome trace: busy seconds as the union of device intervals
inside the window, kernel times by name, idle gaps by host activity."""

import json

import pytest

from benchmark import tracing
from benchmark.run import TracedRun


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


@pytest.fixture
def trace_file(tmp_path):
    events = [
        _x(tracing.WINDOW, "user_annotation", 1000.0, 1000.0),
        _x("bench.interaction", "user_annotation", 1000.0, 400.0),
        _x("aten::mm", "cpu_op", 1010.0, 30.0),
        _x("bench.sync", "user_annotation", 1400.0, 550.0),
        _x("void moments_kernel<float>(float const*)", "kernel",
           1050.0, 300.0),
        _x("void moments_kernel<float>(float const*)", "kernel",
           1300.0, 100.0),  # overlaps the first
        _x("Memcpy DtoD", "gpu_memcpy", 1500.0, 100.0),
        _x("void other_kernel()", "kernel", 2500.0, 50.0),  # outside
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_busy_window_and_kernels(trace_file):
    t = tracing.read(trace_file)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx(450e-6)  # 1050-1400 and 1500-1600
    assert t.kernel_seconds(r"\bmoments_kernel\b") == (
        pytest.approx(400e-6), 2)
    assert t.device_ops[0] == ["moments_kernel<float>",
                               pytest.approx(400e-6)]
    gaps = dict(t.idle_gaps)
    assert gaps["aten::mm"] == pytest.approx(50e-6)  # 1000-1050
    assert gaps["bench.sync"] == pytest.approx(100e-6 + 400e-6)


def test_roofline_reader(trace_file):
    t = tracing.read(trace_file)
    shapes = [{"e": 50, "v": 1000, "bytes_per_value": 4}] * 2
    run = TracedRun(None, {}, [], t)
    from benchmark.bounds import b1
    least = 2 * b1.least(shapes[0])[0]
    assert run.roofline("b1", r"\bmoments_kernel\b", shapes) == \
        pytest.approx(100 * least / 400e-6)
    assert run.roofline("k3", r"\bcomposite_kernel\b", shapes) is None
    assert run.roofline("b1", r"\bmoments_kernel\b", []) is None


def test_roofline_readers_count_their_launches_from_the_cell(trace_file):
    """B1's reader counts a launch a member chunk an interaction; the
    Scene's kernels' readers stay silent in a streamed cell."""
    from bench_helpers import tiny_cell
    from benchmark import spec
    from benchmark.bounds import b1
    cell = tiny_cell("synthbox250-m1000-pearson-field")
    ds, serve = cell.config["dataset"], cell.config["serve"]
    run = TracedRun(cell, {}, [{"point": (1, 2, 3)}] * 3,
                    tracing.read(trace_file))
    launches = 3 * ds["members"] // serve["chunk_members"]
    shape = {"e": serve["chunk_members"],
             "v": ds["xs"] * ds["ys"] * ds["zs"], "bytes_per_value": 4}
    assert spec.load_module("metrics", "b1_roofline").read(run) == \
        pytest.approx(100 * launches * b1.least(shape)[0] / 400e-6)
    for name in ("k1_roofline", "b10_roofline", "k3_roofline"):
        assert spec.load_module("metrics", name).read(run) is None
