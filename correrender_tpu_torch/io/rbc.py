"""Rayleigh-Bénard convection ``.bin`` snapshot loader.

Group-internal format (reference src/Loaders/RbcBinFileLoader.cpp):
one raw little-endian float32 block of shape (Z=1024, Y=32, X=1024, 4)
with interleaved components (vx, vy, vz, temperature) and grid spacing
1/1023 on every axis. The reference eagerly derives Velocity/Vorticity
magnitudes and Helicity on load (RbcBinFileLoader.cpp:100-116); here
the u/v/w component fields trigger the same derived fields as virtual
calculator fields via ``io.base._auto_register_velocity`` — identical
user surface, computed lazily on the device instead. A copy of
``correrender_tpu/io/rbc.py``.
"""

from __future__ import annotations

import numpy as np

from correrender_tpu_torch.io.base import VolumeLoader, register_loader

#: Fixed grid of the RBC snapshots (RbcBinFileLoader.cpp:42-46).
_XS, _YS, _ZS = 1024, 32, 1024
_CELL_STEP = 1.0 / 1023.0
_COMPONENTS = ("u", "v", "w", "Temperature")


@register_loader
class RbcBinLoader(VolumeLoader):
    extensions = ("bin",)

    def open(self, path, dataset_info=None):
        import os

        size = os.path.getsize(path)
        expected = _XS * _YS * _ZS * 4 * 4
        if size != expected:
            raise ValueError(
                f"{path!r} is {size} bytes, expected {expected} "
                f"(RBC .bin is a fixed {_XS}x{_YS}x{_ZS}x4 float32 block)"
            )
        self.path = path
        self.xs, self.ys, self.zs = _XS, _YS, _ZS
        self.dx = self.dy = self.dz = _CELL_STEP
        self.field_names = list(_COMPONENTS)
        self._data = None
        return self

    def _block(self):
        if self._data is None:
            self._data = np.fromfile(
                self.path, dtype="<f4"
            ).reshape(_ZS, _YS, _XS, 4)
        return self._data

    def load_field(self, name, time=0, member=0):
        idx = _COMPONENTS.index(name)
        return np.ascontiguousarray(self._block()[..., idx], np.float32)
