"""Scene layer: device operations (kernels, copies, sets) launched inside
the program's ``scene.render_view`` zone, per frame of the traced window
(``program_trace.py``)."""

from benchmark import program_trace


def read(run):
    t = program_trace.of_run(run)
    return None if t is None else t.per_frame(t.launches)
