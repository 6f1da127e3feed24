"""Scene layer: the host's mean milliseconds a frame inside the calls
that move the point or the camera and render the view, until they
return (the synchronise excluded): what the host pays to dispatch a
frame."""


def read(run):
    return run.span_mean("scene_host_ms")
