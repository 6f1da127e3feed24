"""Render layer: mean device milliseconds a frame of the operations
launched inside the program's ``dvr.warp`` zone (``dvr_shearwarp``'s warp
of the intermediate image to the screen), read from the traced window
(``program_trace.py``)."""

from benchmark import program_trace


def read(run):
    t = program_trace.of_run(run)
    ms = None if t is None else t.per_frame(t.device_us, "dvr.warp")
    return None if ms is None else ms * 1e-3
