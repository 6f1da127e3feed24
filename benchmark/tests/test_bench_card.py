"""On the card: one short run of each cell through the command itself
(``python3 -m pytest benchmark/tests -m card`` on a machine with a GPU)."""

import json
import subprocess
import sys

import pytest

from bench_helpers import CELLS, SEED
from benchmark import spec


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the GPU only")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "6", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "check"


def test_run_without_a_card_exits_nonzero():
    """Without a CUDA device (this CPU build) the command prints no
    result and exits non-zero."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[1],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
