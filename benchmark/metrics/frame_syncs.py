"""Scene layer: runtime and driver calls inside the program's
``scene.render_view`` zone that wait for the card
(``program_trace.SYNC_CALLS``), per frame of the traced window."""

from benchmark import program_trace


def read(run):
    t = program_trace.of_run(run)
    return None if t is None else t.per_frame(t.syncs)
