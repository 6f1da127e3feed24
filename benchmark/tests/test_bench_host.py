"""The host probe, its reader, and the split of the end-to-end metrics
by what paces a cell's interactions."""

import json
import subprocess
import sys

import pytest

from benchmark import host, spec
from benchmark.run import TracedRun

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_the_probe_does_the_same_work_on_every_call():
    counts = {host.probe() for _ in range(3)}
    assert len(counts) == 1 and counts.pop() > host.WALK_STEPS
    times = host.probe_ms(2)
    assert len(times) == 2 and all(t > 0 for t in times)


def test_the_probe_loads_neither_torch_nor_the_port_nor_jax():
    code = ("from benchmark import host\nhost.probe()\nimport sys, json\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(spec.ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"torch", "correrender_tpu_torch", "correrender_tpu",
                        "jax", "jaxlib", "flax"}


def test_host_probe_ms_reads_the_runs_median():
    read = spec.load_module("metrics", "host_probe_ms").read
    assert read(TracedRun(None, {}, [], None, [21.0, 19.5, 30.0])) == 21.0
    assert read(TracedRun(None, {}, [], None)) is None


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_reports_one_latency_and_at_most_one_rate(cell):
    loaded = spec.load_cell(cell)
    units = [m["unit"] for m in loaded.end_to_end if m["name"] != "setup_s"]
    assert units.count("ms") == 1
    assert len(units) - units.count("ms") <= 1
    per_layer = {m["name"] for m in loaded.per_layer}
    assert "host_probe_ms" in per_layer


DEVICEPACED = [m for m in BENCH["per_layer"]
               if m["name"].endswith(".devicepaced")]


@pytest.mark.parametrize("entry", DEVICEPACED, ids=lambda m: m["name"])
def test_a_devicepaced_metric_reads_its_base_in_the_device_paced_cells(entry):
    base_name = entry["name"].rsplit(".", 1)[0]
    base = {m["name"]: m for m in BENCH["per_layer"]}[base_name]
    assert (entry["unit"], entry["better"], entry["layer"]) == (
        base["unit"], base["better"], base["layer"])
    assert not set(entry["workloads"]) & set(base["workloads"])
    hostpaced = {m["name"] for m in BENCH["end_to_end"]
                 if m["name"].startswith("hostpaced_")}
    assert base["moves"] in hostpaced and entry["moves"] not in hostpaced
    spans = {"scene_host_ms": [2.0, 4.0], "field_ms": [1.0],
             "render_ms": [3.0, 5.0]}
    run = TracedRun(spec.load_cell(entry["workloads"][0]), spans, [], None)
    read = spec.load_module("metrics", entry["name"]).read
    assert read(run) == spec.load_module("metrics", base_name).read(run)
