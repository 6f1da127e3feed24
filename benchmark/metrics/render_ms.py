"""Render layer: mean device milliseconds a frame of the span (CUDA
events) around ``Scene.render_view`` with the field ready: K2, K3 and
the warp, and their dispatch."""


def read(run):
    return run.span_mean("render_ms")
