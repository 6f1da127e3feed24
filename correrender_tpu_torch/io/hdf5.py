"""Plain HDF5 loader (reference: src/Loaders/Hdf5Loader.cpp).

A copy of ``correrender_tpu/io/hdf5.py``. ``h5py`` is imported when a
file is opened, never with the module: an installation without it reads
every other format.
"""

from __future__ import annotations

import numpy as np

from correrender_tpu_torch.io.base import VolumeLoader, register_loader


@register_loader
class Hdf5Loader(VolumeLoader):
    extensions = ("h5", "hdf5", "he5")

    def open(self, path, dataset_info=None):
        import h5py

        self.path = path
        self._h5 = h5py.File(path, "r")
        self._vars = {}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset) and 3 <= obj.ndim <= 5:
                self._vars[name] = obj.shape

        self._h5.visititems(visit)
        if not self._vars:
            raise ValueError(f"{path}: no 3D..5D datasets found")
        for name, shape in self._vars.items():
            if len(shape) == 3:
                self.zs, self.ys, self.xs = shape
            elif len(shape) == 4:
                self.ts = max(self.ts, shape[0])
                self.zs, self.ys, self.xs = shape[1:]
            else:
                self.es = max(self.es, shape[0])
                self.ts = max(self.ts, shape[1])
                self.zs, self.ys, self.xs = shape[2:]
        self.field_names = list(self._vars)
        return self

    def load_field(self, name, time=0, member=0):
        ds = self._h5[name]
        if ds.ndim == 3:
            arr = ds[...]
        elif ds.ndim == 4:
            arr = ds[time]
        else:
            arr = ds[member, time]
        return np.asarray(arr, np.float32)

    def close(self):
        self._h5.close()
