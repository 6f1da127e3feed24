"""Rendering: cameras, transfer functions and the volume renderers.

Counterpart of ``correrender_tpu/render``, with its package exports. The
heavier renderers (``dvr_shearwarp``, ``iso_render``,
``world_map_render``) are imported on first access, as in JAX.
"""

from correrender_tpu_torch.render.camera import Camera, orbit_camera
from correrender_tpu_torch.render.tf import TransferFunction
from correrender_tpu_torch.render.dvr import dvr_render
from correrender_tpu_torch.render.sampling import sample_trilinear

__all__ = [
    "Camera",
    "orbit_camera",
    "TransferFunction",
    "dvr_render",
    "sample_trilinear",
]


def __getattr__(name):
    if name == "dvr_shearwarp":
        from correrender_tpu_torch.render.dvr_fast import dvr_shearwarp

        return dvr_shearwarp
    if name == "iso_render":
        from correrender_tpu_torch.render.iso import iso_render

        return iso_render
    if name == "world_map_render":
        from correrender_tpu_torch.render.worldmap import world_map_render

        return world_map_render
    raise AttributeError(name)
