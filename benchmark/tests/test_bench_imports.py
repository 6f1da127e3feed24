"""The import guard: nothing the benchmark loads is JAX or the JAX
package, and the references load nothing of the port.

Top-level module names are compared whole (the port's name begins with
the JAX package's). Each check runs in a fresh interpreter."""

import json
import subprocess
import sys

import pytest

from bench_helpers import CELLS
from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "correrender_tpu"}


def _top_level_names(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(spec.ROOT),
             "HOME": str(spec.ROOT / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules(folder: str) -> list[str]:
    base = spec.HERE / folder if folder else spec.HERE
    return sorted(f"benchmark.{folder + '.' if folder else ''}{p.stem}"
                  for p in base.glob("*.py") if p.stem != "__init__")


def test_benchmark_modules_load_no_jax():
    mods = _modules("") + _modules("reference") + _modules("bounds")
    code = "\n".join(f"import {m}" for m in mods)
    code += "\nfrom benchmark import spec\n" + "\n".join(
        f"spec.load_module({kind!r}, {p.stem!r})"
        for kind in ("metrics", "drivers", "interactions")
        for p in (spec.HERE / kind).glob("*.py") if p.stem != "__init__")
    assert not _top_level_names(code) & FORBIDDEN


@pytest.mark.parametrize("name", CELLS)
def test_a_whole_run_loads_no_jax(name):
    """A run on the CPU at a small size, with the port loaded and every
    metric read, leaves no forbidden module in the process."""
    code = f"""
import sys
sys.path.insert(0, {str(spec.HERE / 'tests')!r})
import torch
from bench_helpers import tiny_cell, SEED
from benchmark.run import run_cell, forbidden_modules
result = run_cell(tiny_cell({name!r}), SEED, 0.2, True, torch.device('cpu'))
assert result is not None and not forbidden_modules()
assert 'correrender_tpu_torch' in sys.modules
"""
    names = _top_level_names(code)
    assert "correrender_tpu_torch" in names
    assert not names & FORBIDDEN


def test_references_load_nothing_of_the_port():
    code = "\n".join(f"import {m}" for m in _modules("reference"))
    names = _top_level_names(code)
    assert not names & (FORBIDDEN | {"correrender_tpu_torch"})


def test_no_result_is_printed_once_a_forbidden_module_is_loaded(
        monkeypatch, capsys):
    """The last look comes just before the result line: a module loaded
    after the window (a metric's reader, a bound, the check) counts."""
    import types

    from benchmark import run
    result = {"correct": True, "check": {"field_gap": {
        "value": 0.0, "limit": 1.0}}}
    assert run.emit(result) == 0
    assert capsys.readouterr().out.strip().startswith("{")
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.emit(result) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "jax" in captured.err
