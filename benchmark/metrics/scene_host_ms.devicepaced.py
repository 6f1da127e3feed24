"""``scene_host_ms`` in the cells whose interactions wait on the card,
under a name of its own: read as ``scene_host_ms`` is, it moves their
``interaction_ms_p95``."""

from benchmark import spec


def read(run):
    return spec.load_module("metrics", "scene_host_ms").read(run)
