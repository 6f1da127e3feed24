"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; each is a JSON file under this folder
(``configs/<name>.json``, ``traffic/<name>.json``), as are the cell's own
settings (``workloads/<name>.json``: the check's sample and limits, and
where the card may be fed ahead of the host, ``ahead_s``). The code that serves and
checks them is found by the names in those files: the driver
``drivers/<serve.entry>.py``, the interaction kind
``interactions/<interaction>.py``, the references
``reference/<measure>.py`` and ``reference/<serve.renderer>.py``; a
metric's reader is ``metrics/<name>.py`` and a kernel's bound
``bounds/<kernel>.py``. A later cell adds files; it edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


_LOADED: dict = {}


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under this folder, loaded once by its path (a
    metric's name may hold a dot): how the harness finds a driver, an
    interaction kind, a reference, a metric's reader or a kernel's
    bound by the name a cell's files give."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


@dataclasses.dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list

    def reports(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files (the
    configuration's file relative to ``root``, the rest under
    ``<root>/benchmark/``)."""
    bench = _load_json(root / "BENCHMARK.json")
    base = root / "benchmark"
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(base / "traffic" / f"{w['traffic']}.json")
    settings = _load_json(base / "workloads" / f"{name}.json")
    cell = Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, settings=settings, end_to_end=[],
                per_layer=[])
    cell.end_to_end = [m for m in bench["end_to_end"] if cell.reports(m)]
    cell.per_layer = [m for m in bench["per_layer"] if cell.reports(m)]
    return cell
