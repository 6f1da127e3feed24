"""``warp_ms`` in the cells whose interactions wait on the card, under a
name of its own: read as ``warp_ms`` is, it moves their
``frames_per_s``."""

from benchmark import spec


def read(run):
    return spec.load_module("metrics", "warp_ms").read(run)
