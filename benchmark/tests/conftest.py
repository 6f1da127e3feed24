"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

Tests marked ``card`` need an NVIDIA GPU; each decides inside itself
whether one is present and skips with the reason where it is not. The
others run on the CPU, at sizes a test run holds, through the port's
plain versions of its kernels.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips without one")
