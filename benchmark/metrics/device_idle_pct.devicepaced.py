"""``device_idle_pct`` in the cells whose interactions wait on the card,
under a name of its own: read as ``device_idle_pct`` is, it moves their
``interaction_ms_p95``."""

from benchmark import spec


def read(run):
    return spec.load_module("metrics", "device_idle_pct").read(run)
