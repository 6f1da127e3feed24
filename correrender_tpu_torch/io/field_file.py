"""Group-internal .field format loader.

Reference: src/Loaders/FieldFileLoader.{hpp,cpp} — 24-byte header
(uvec3 resolution, u32 dimensions, u32 mipLevels, u32 fieldType) with
interleaved vec3/vec4 payload: fieldType 0 = float32, 1 = float16.
The vector components register as u/v/w (+ p for vec4) scalar fields.
A copy of ``correrender_tpu/io/field_file.py``.
"""

from __future__ import annotations

import struct

import numpy as np

from correrender_tpu_torch.io.base import VolumeLoader, register_loader

_HEADER = struct.Struct("<3I3I")  # resolution xyz, dims, mips, fieldType


@register_loader
class FieldFileLoader(VolumeLoader):
    extensions = ("field",)

    def open(self, path, dataset_info=None):
        self.path = path
        with open(path, "rb") as f:
            header = f.read(_HEADER.size)
            rx, ry, rz, dims, mips, ftype = _HEADER.unpack(header)
        if dims != 3:
            raise ValueError(f"{path}: only 3D .field files supported")
        if ftype not in (0, 1):
            raise ValueError(f"{path}: unknown fieldType {ftype}")
        self.xs, self.ys, self.zs = rx, ry, rz
        self._dtype = np.float32 if ftype == 0 else np.float16
        import os

        total = os.path.getsize(path) - _HEADER.size
        cells = rx * ry * rz
        itemsize = np.dtype(self._dtype).itemsize
        self._ncomp = total // (cells * itemsize)
        if self._ncomp not in (3, 4):
            raise ValueError(
                f"{path}: payload is {self._ncomp} components/cell, "
                "expected vec3/vec4"
            )
        self.field_names = ["u", "v", "w"] + (
            ["p"] if self._ncomp == 4 else []
        )
        return self

    def load_field(self, name, time=0, member=0):
        comp = self.field_names.index(name)
        data = np.fromfile(self.path, dtype=self._dtype,
                           offset=_HEADER.size)
        cells = self.xs * self.ys * self.zs
        data = data[: cells * self._ncomp].reshape(cells, self._ncomp)
        return (
            data[:, comp].astype(np.float32)
            .reshape(self.zs, self.ys, self.xs)
        )
