"""Field layer: mean device milliseconds a frame of the span (CUDA
events) around ``VolumeData.get_field`` after the reference point moved:
the correlation field's kernels and their dispatch."""


def read(run):
    return run.span_mean("field_ms")
