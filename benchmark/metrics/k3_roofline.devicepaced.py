"""``k3_roofline`` in the cells whose interactions wait on the card,
under a name of its own: read as ``k3_roofline`` is, it moves their
``frames_per_s``."""

from benchmark import spec


def read(run):
    return spec.load_module("metrics", "k3_roofline").read(run)
