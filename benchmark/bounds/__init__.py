"""The least time of each kernel's work on the chip: its bytes over the
chip's memory rate or its operations over its float32 rate, the larger.
``peaks.json`` holds the published peaks; ``<kernel>.py`` counts one
launch's bytes and operations from its shapes."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def least_seconds(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations") of the larger bound."""
    t_bytes = bytes_moved / PEAKS["hbm_bytes_per_s"]
    t_ops = ops / PEAKS["f32_ops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
