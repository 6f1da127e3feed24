"""AmiraMesh (.am) loader — uniform-lattice scalar fields.

Reference: src/Loaders/AmiraMeshLoader.cpp. Supports the common
``# AmiraMesh BINARY-LITTLE-ENDIAN 2.1`` uniform-grid layout with one
Lattice data section. A copy of ``correrender_tpu/io/amira.py``.
"""

from __future__ import annotations

import re

import numpy as np

from correrender_tpu_torch.io.base import VolumeLoader, register_loader


@register_loader
class AmiraMeshLoader(VolumeLoader):
    extensions = ("am",)

    def open(self, path, dataset_info=None):
        self.path = path
        with open(path, "rb") as f:
            self._content = f.read()
        header = self._content[:4096].decode("ascii", "replace")
        if "AmiraMesh" not in header:
            raise ValueError(f"{path}: not an AmiraMesh file")
        self._little = "BINARY-LITTLE-ENDIAN" in header
        m = re.search(r"define\s+Lattice\s+(\d+)\s+(\d+)\s+(\d+)", header)
        if not m:
            raise ValueError(f"{path}: no uniform Lattice definition")
        self.xs, self.ys, self.zs = (int(g) for g in m.groups())
        bb = re.search(
            r"BoundingBox\s+([\d.eE+-]+)\s+([\d.eE+-]+)\s+([\d.eE+-]+)"
            r"\s+([\d.eE+-]+)\s+([\d.eE+-]+)\s+([\d.eE+-]+)",
            header,
        )
        if bb:
            x0, x1, y0, y1, z0, z1 = (float(g) for g in bb.groups())
            self.dx = (x1 - x0) / max(self.xs - 1, 1)
            self.dy = (y1 - y0) / max(self.ys - 1, 1)
            self.dz = (z1 - z0) / max(self.zs - 1, 1)
        fm = re.search(r"Lattice\s*\{\s*(\w+)\s+(\w+)\s*\}", header)
        self._dtype = {
            "float": np.float32,
            "double": np.float64,
            "byte": np.uint8,
            "short": np.int16,
            "ushort": np.uint16,
        }.get(fm.group(1) if fm else "float", np.float32)
        self.field_names = [fm.group(2) if fm else "Lattice"]
        return self

    def load_field(self, name, time=0, member=0):
        # Data follows the "@1" marker line.
        marker = self._content.index(b"\n@1")
        start = self._content.index(b"\n", marker + 1) + 1
        n = self.xs * self.ys * self.zs
        dtype = np.dtype(self._dtype)
        if not self._little:
            dtype = dtype.newbyteorder(">")
        arr = np.frombuffer(self._content, dtype=dtype, count=n, offset=start)
        return arr.astype(np.float32).reshape(self.zs, self.ys, self.xs)
