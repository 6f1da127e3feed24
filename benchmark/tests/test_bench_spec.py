"""BENCHMARK.json against the benchmark's contract, and the data-driven
lookup: a cell added by files alone is found."""

import json
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert all(_line(w) for w in BENCH["command"])
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])


def test_names_units_and_lines():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert _line(entry[key]), (entry["name"], key)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])


def test_metrics_are_reported_where_listed():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        loaded = spec.load_cell(cell)
        assert len(loaded.end_to_end) >= 2 and loaded.per_layer


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_its_files(cell):
    loaded = spec.load_cell(cell)
    assert loaded.config["reduced"] == []
    assert set(loaded.settings["limits"]) >= {"field_gap"}


def test_a_cell_added_by_files_alone_is_found(tmp_path):
    """A later change adds a traffic mix, a cell's settings and an entry,
    and names the cell in the metrics it reports: no existing file of the
    benchmark is edited."""
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    mix = json.loads((spec.HERE / "traffic" / "pearson-drag.json")
                     .read_text())
    mix["step_max"] = 8
    (tmp_path / "benchmark" / "traffic" / "pearson-long-drag.json"
     ).write_text(json.dumps(mix))
    (tmp_path / "benchmark" / "workloads" / "linear4x4-long-drag.json"
     ).write_text((spec.HERE / "workloads" / "linear4x4-pearson-drag.json")
                  .read_text())
    bench["workloads"].append({"name": "linear4x4-long-drag",
                               "config": "linear4x4-m1000",
                               "traffic": "pearson-long-drag", "chips": 1,
                               "why": "longer steps"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("hostpaced_ms_p95", "device_idle_pct"):
            m["workloads"].append("linear4x4-long-drag")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("linear4x4-long-drag", root=tmp_path)
    assert cell.traffic["step_max"] == 8
    assert {m["name"] for m in cell.end_to_end} == {
        "hostpaced_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"device_idle_pct",
                                                   "host_probe_ms"}


def test_a_kind_a_driver_and_a_reference_are_found_by_name(tmp_path,
                                                            monkeypatch):
    """A later cell that needs a new interaction kind, serving entry or
    measure adds a file for each, named in its mix or configuration."""
    from benchmark import check, drivers, traffic
    base = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (base / "interactions" / "fixed_point.py").write_text(
        "def window(mix, grid_xyz, gen):\n"
        "    while True:\n"
        "        yield {'point': tuple(mix['point'])}\n\n\n"
        "def warmup(mix, grid_xyz, gen, count):\n"
        "    return [{'point': tuple(mix['point'])}] * count\n")
    (base / "drivers" / "echo.py").write_text(
        "class Driver:\n"
        "    def __init__(self, config, mix, seed, device,\n"
        "                 low_precision=False):\n"
        "        self.seed = seed\n")
    (base / "reference" / "spearman.py").write_text(
        "def field(blocks, points, mix, voxels=None):\n"
        "    return None\n")
    monkeypatch.setattr(spec, "HERE", base)
    mix = {"interaction": "fixed_point", "point": [1, 2, 3],
           "measure": "spearman"}
    assert next(traffic.interactions(mix, (8, 8, 8), 5)) == {
        "point": (1, 2, 3)}
    assert traffic.warmup(mix, (8, 8, 8), 5, 2) == [{"point": (1, 2, 3)}] * 2
    driver = drivers.make({"serve": {"entry": "echo"}}, mix, 9, "cpu")
    assert driver.seed == 9
    cell = spec.Cell(name="c", chips=1, config={"serve": {"entry": "echo"}},
                     traffic=mix, settings={}, end_to_end=[], per_layer=[])
    measure, frame = check.references(cell)
    assert measure.field(None, [], mix) is None and frame is None


def test_what_the_benchmark_cannot_serve_or_check_is_refused():
    """A renderer setting the frame reference does not draw, or a measure
    with no reference, fails before any set-up."""
    from benchmark import check
    cell = spec.load_cell("linear4x4-pearson-drag")
    cell.config["serve"]["renderer_settings"]["quality"] = "exact"
    with pytest.raises(ValueError, match="quality"):
        check.references(cell)
    cell = spec.load_cell("linear4x4-pearson-drag")
    cell.traffic["measure"] = "kendall"
    with pytest.raises(FileNotFoundError, match="kendall"):
        check.references(cell)
