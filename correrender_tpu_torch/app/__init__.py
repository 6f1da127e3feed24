"""Application layer: the Scene, state files, the command line, the
viewer, the BASELINE configurations and the harnesses.

Counterpart of ``correrender_tpu/app``, with its package exports: a
:class:`Scene` owns a ``VolumeData``, calculators and renderer configs and
renders views on demand; its JSON state files keep the reference's
schema (src/MainAppState.cpp).
"""

from correrender_tpu_torch.app.state import Scene, RENDERING_MODE_IDS
from correrender_tpu_torch.app import perf, sampling_test, replicability

__all__ = [
    "Scene",
    "RENDERING_MODE_IDS",
    "perf",
    "sampling_test",
    "replicability",
]
