"""Scene layer: the host's milliseconds a frame inside the program's
``scene.render_view`` zone spent in CUDA runtime and driver calls,
launches and waits alike (their union on the thread): the part of the
frame's host time that the card holds the host for, read from the
traced window (``program_trace.py``)."""

from benchmark import program_trace


def read(run):
    t = program_trace.of_run(run)
    us = None if t is None else t.per_frame(t.api_us)
    return None if us is None else us * 1e-3
