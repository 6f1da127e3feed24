"""Per-layer metric readers, one file a metric, found by the metric's
name. Each has ``read(run) -> float | None``: ``run`` is a
:class:`benchmark.run.TracedRun` (the cell, its spans, the traced
window's interactions and the device trace); a roofline's reader counts
its kernel's launches from the cell and the interactions. A reader that
finds nothing to read returns None, and the metric is left out of the
result line."""
