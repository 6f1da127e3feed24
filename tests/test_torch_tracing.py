"""The port's zones (``utils/profiling.zone``) in the profiler's trace and
the benchmark's readers of them (``benchmark/program_trace.py``).

With no profiler a zone records nothing; under :func:`profiling.trace`
the Scene's frame, the field, the layout, the composite, the warp, the
streamed field and the viewer's frame appear as nested
``user_annotation`` ranges. The readers are held to exact values on a
hand-built Chrome trace and stay silent on a CPU trace.
"""

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from benchmark import program_trace, spec, tracing
from benchmark.run import TracedRun
from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.app.viewer import ViewerApp
from correrender_tpu_torch.calculators.correlation import (
    CorrelationCalculator,
    pearson_streamed,
)
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.utils import profiling

GRID = (16, 12, 8)  # x, y, z
MEMBERS = 24
IMAGE = (64, 48)
CAMERA = (0.05, 0.3, 0.85)
READERS = ("warp_ms", "frame_launches", "frame_syncs", "scene_wait_ms")


def tiny_scene():
    """A Pearson ``VolumeData`` of 16×12×8 × 24 seeded members and a Scene
    with one ``dvr`` renderer; one frame drawn."""
    xs, ys, zs = GRID
    data = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (MEMBERS, zs, ys, xs)).astype(np.float32))
    vd = VolumeData(GridMetadata(xs=xs, ys=ys, zs=zs, ts=1, es=MEMBERS),
                    device="cpu")
    vd.add_field("q", lambda t, e: data[e])
    calc = CorrelationCalculator(field_name="q", reference_point=(4, 5, 3))
    scene = Scene(vd, [Camera(position=CAMERA)])
    name = scene.add_calculator(calc)
    scene.add_renderer("dvr", field=name)
    scene.render_view(0, image_size=IMAGE)
    return scene, calc


def annotations(log_dir):
    doc = json.load(open(log_dir / "trace.json"))
    return [e for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def holds(outer, inner) -> bool:
    return (outer["tid"] == inner["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def one(events, name):
    found = [e for e in events if e["name"] == name]
    assert len(found) == 1, (name, [e["name"] for e in events])
    return found[0]


def test_no_zone_opens_a_range_without_a_profiler(monkeypatch):
    scene, calc = tiny_scene()
    opened = []

    class Counting(record_function):
        def __init__(self, name, *args):
            opened.append(name)
            super().__init__(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    calc.set_reference_point(9, 2, 6)
    scene.render_view(0, image_size=IMAGE)
    assert opened == []
    # One shared context, whatever the name: nothing is kept or made.
    assert profiling.zone("a") is profiling.zone("b")
    assert not hasattr(profiling, "_TIMINGS")
    assert not hasattr(profiling, "timing_summary")


def test_a_point_move_records_the_frame_field_layout_composite_warp(
        tmp_path):
    scene, calc = tiny_scene()
    calc.set_reference_point(9, 2, 6)
    with profiling.trace(str(tmp_path)):
        scene.render_view(0, image_size=IMAGE)
    ev = annotations(tmp_path)
    frame = one(ev, "scene.render_view")
    dvr = one(ev, "render.dvr")
    assert holds(frame, one(ev, "field.compute"))
    assert holds(frame, dvr)
    assert not holds(dvr, one(ev, "field.compute"))
    for name in ("render.layout", "dvr.composite", "dvr.warp"):
        assert holds(dvr, one(ev, name)), name
    assert one(ev, "dvr.composite")["ts"] < one(ev, "dvr.warp")["ts"]
    assert not [e for e in ev if e["name"] == "dvr.exact"]


def test_a_camera_move_with_its_layout_cached_records_no_field_or_layout(
        tmp_path):
    scene, _ = tiny_scene()
    scene.views[0] = Camera(position=(0.07, 0.28, 0.86))
    with profiling.trace(str(tmp_path)):
        scene.render_view(0, image_size=IMAGE)
    names = [e["name"] for e in annotations(tmp_path)]
    assert "field.compute" not in names and "render.layout" not in names
    assert {"scene.render_view", "render.dvr", "dvr.composite",
            "dvr.warp"} <= set(names)


def test_the_exact_marcher_is_its_own_zone(tmp_path):
    scene, _ = tiny_scene()
    scene.renderers[0]["quality"] = "exact"
    with profiling.trace(str(tmp_path)):
        scene.render_view(0, image_size=IMAGE)
    ev = annotations(tmp_path)
    assert holds(one(ev, "render.dvr"), one(ev, "dvr.exact"))
    assert not [e for e in ev if e["name"] in ("dvr.composite", "dvr.warp")]


def test_pearson_streamed_records_its_zone(tmp_path):
    g = torch.Generator().manual_seed(5)
    members = torch.randn((MEMBERS, 4, 5, 6), generator=g)
    ref = members[:, 1, 2, 3].clone()
    with profiling.trace(str(tmp_path)):
        field = pearson_streamed(members.split(10), ref)
    assert field.shape == (4, 5, 6)
    one(annotations(tmp_path), "field.streamed")


def test_the_viewers_frame_records_render_overlay_and_encode(tmp_path):
    scene, _ = tiny_scene()
    app = ViewerApp(scene, image_size=IMAGE)
    with profiling.trace(str(tmp_path)):
        png, timing = app._frame()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and timing["total_ms"] > 0
    ev = annotations(tmp_path)
    frame, overlay, encode = (one(ev, f"viewer.{n}")
                              for n in ("frame", "overlay", "encode"))
    assert frame["ts"] + frame["dur"] <= overlay["ts"]
    assert overlay["ts"] + overlay["dur"] <= encode["ts"]
    assert holds(frame, one(ev, "dvr.warp"))


# -- the benchmark's readers -------------------------------------------------

def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1 if cat in ("user_annotation", "cpu_op", "cuda_runtime",
                             "cuda_driver") else 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _api(name, ts, dur, corr, tid=1, cat="cuda_runtime"):
    return _x(name, cat, ts, dur, tid, corr)


def _dev(name, ts, dur, corr, cat="kernel"):
    return _x(name, cat, ts, dur, 7, corr)


def hand_built_trace():
    """A window, two interactions (a point move, then a camera move) with
    the program's zones nested, launches with correlation ids, kernels,
    copies, one ``cudaStreamSynchronize`` and one synchronous
    ``cudaMemcpy``, a launch on another thread and a kernel after the
    window."""
    ua = "user_annotation"
    return [
        _x(tracing.WINDOW, ua, 1000.0, 2000.0),
        _x("bench.interaction", ua, 1000.0, 900.0),
        _x("scene.render_view", ua, 1010.0, 790.0),
        _x("field.compute", ua, 1020.0, 80.0),
        _api("cudaLaunchKernel", 1030.0, 10.0, 1),
        _dev("pearson_tiled_kernel", 1050.0, 100.0, 1),
        _x("render.dvr", ua, 1100.0, 690.0),
        _x("render.layout", ua, 1110.0, 90.0),
        _api("cudaLaunchKernel", 1120.0, 10.0, 2),
        _dev("classify_to_cf_kernel", 1200.0, 20.0, 2),
        _x("dvr.composite", ua, 1200.0, 100.0),
        _api("cudaLaunchKernel", 1210.0, 10.0, 3),
        _dev("composite_taps_kernel", 1250.0, 30.0, 3),
        _x("dvr.warp", ua, 1300.0, 480.0),
        _x("aten::bmm", "cpu_op", 1305.0, 25.0),
        _api("cudaLaunchKernel", 1310.0, 10.0, 4),
        _dev("gemm_kernel", 1320.0, 200.0, 4),
        _api("cudaMemcpyAsync", 1400.0, 5.0, 5),
        _dev("Memcpy DtoH", 1530.0, 10.0, 5, "gpu_memcpy"),
        _api("cudaStreamSynchronize", 1500.0, 60.0, 6),
        # Another thread's launch while the first frame runs: not its.
        _api("cudaLaunchKernel", 1500.0, 10.0, 12, tid=2),
        _dev("other_thread_kernel", 1600.0, 5.0, 12),
        _x("bench.sync", ua, 1900.0, 50.0),
        _api("cudaDeviceSynchronize", 1900.0, 40.0, 7),
        _x("bench.interaction", ua, 2000.0, 500.0),
        _x("scene.render_view", ua, 2010.0, 390.0),
        _x("render.dvr", ua, 2020.0, 370.0),
        _x("dvr.composite", ua, 2030.0, 70.0),
        _api("cuLaunchKernel", 2040.0, 10.0, 8, cat="cuda_driver"),
        _dev("composite_taps_kernel", 2060.0, 30.0, 8),
        _x("dvr.warp", ua, 2100.0, 280.0),
        _api("cudaLaunchKernel", 2110.0, 10.0, 9),
        _dev("gemm_kernel", 2130.0, 250.0, 9),
        _api("cudaMemcpy", 2300.0, 20.0, 10),
        _dev("Memcpy DtoH", 2385.0, 10.0, 10, "gpu_memcpy"),
        # Launched in the window, run after it.
        _api("cudaLaunchKernel", 2950.0, 10.0, 11),
        _dev("late_kernel", 3100.0, 50.0, 11),
    ]


def traced_run(monkeypatch, tmp_path, events, name="cell"):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(program_trace, "TRACES", tmp_path)
    return TracedRun(types.SimpleNamespace(name=name), {}, [],
                     tracing.read(path))


def test_program_trace_attributes_by_correlation_and_thread(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": hand_built_trace()}))
    t = program_trace.read(path)
    assert t.frames == 2 and t.zones["dvr.warp"] == 2
    assert t.zones["field.compute"] == t.zones["render.layout"] == 1
    assert t.device_ops == 9
    assert t.launches == {"scene.render_view": 8, "field.compute": 1,
                          "render.dvr": 7, "render.layout": 1,
                          "dvr.composite": 2, "dvr.warp": 4}
    assert t.device_us["dvr.warp"] == 200 + 10 + 250 + 10
    assert t.device_us["field.compute"] == 100
    # The one operation launched outside every zone counts in no zone.
    assert t.device_us["scene.render_view"] == 100 + 20 + 60 + 470
    assert t.device_us["render.dvr"] == 20 + 60 + 470
    assert t.syncs["scene.render_view"] == 2
    assert t.api_us["scene.render_view"] == (10 + 10 + 10 + 10 + 5 + 60
                                             + 10 + 10 + 20)
    assert program_trace.read(path) is t  # read once a file


@pytest.mark.parametrize("name, want", [
    ("warp_ms", (210 + 260) / 2 * 1e-3),
    ("frame_launches", 8 / 2),
    ("frame_syncs", 2 / 2),
    ("scene_wait_ms", 145 / 2 * 1e-3),
])
def test_readers_on_a_hand_built_trace(monkeypatch, tmp_path, name, want):
    run = traced_run(monkeypatch, tmp_path, hand_built_trace())
    assert spec.load_module("metrics", name).read(run) == \
        pytest.approx(want, rel=1e-12)


def test_readers_are_silent_without_zones_or_device_operations(
        monkeypatch, tmp_path):
    # A parent without zones: the same trace with the program's gone.
    bare = [e for e in hand_built_trace()
            if not program_trace.is_program_zone(e)]
    run = traced_run(monkeypatch, tmp_path, bare, "bare")
    assert [spec.load_module("metrics", n).read(run) for n in READERS] \
        == [None] * 4
    # The CPU trace of a Scene frame: zones, no device operation.
    scene, calc = tiny_scene()
    calc.set_reference_point(9, 2, 6)
    with profiling.trace(str(tmp_path / "cpu")):
        with record_function(tracing.WINDOW):
            scene.render_view(0, image_size=IMAGE)
    doc = json.load(open(tmp_path / "cpu" / "trace.json"))
    run = traced_run(monkeypatch, tmp_path, doc["traceEvents"], "cpu")
    assert program_trace.of_run(run).frames == 1
    assert [spec.load_module("metrics", n).read(run) for n in READERS] \
        == [None] * 4
    # No trace at all.
    run = TracedRun(types.SimpleNamespace(name="none"), {}, [], None)
    assert [spec.load_module("metrics", n).read(run) for n in READERS] \
        == [None] * 4
