"""``frame_launches`` in the cells whose interactions wait on the card,
under a name of its own: read as ``frame_launches`` is, it moves their
``interaction_ms_p95``."""

from benchmark import spec


def read(run):
    return spec.load_module("metrics", "frame_launches").read(run)
