"""``field_ms`` in the cells whose interactions wait on the card, under
a name of its own: read as ``field_ms`` is, it moves their
``frames_per_s``."""

from benchmark import spec


def read(run):
    return spec.load_module("metrics", "field_ms").read(run)
