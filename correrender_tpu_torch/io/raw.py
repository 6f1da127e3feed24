"""Binary volume formats: the reference's .dat descriptor + .raw payload,
and a standalone .raw named ``name_XxYxZ_dtype.raw``.

A copy of the .dat and .raw loaders of ``correrender_tpu/io/raw.py``
(reference: DatRawFileLoader, src/Loaders/); the JAX module's .mhd,
.cvol and .ctl loaders are not ported yet (ROADMAP A.15).
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from correrender_tpu_torch.io.base import VolumeLoader, register_loader

_DAT_FORMATS = {
    "uchar": np.uint8,
    "byte": np.int8,
    "ushort": np.uint16,
    "short": np.int16,
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "uint": np.uint32,
    # Explicit width-suffixed tokens: without them, filename sniffing
    # longest-matched 'uint' INSIDE '_uint8'/'_uint16' and loaded the
    # volume as uint32 (the 'short'-in-'ushort' substring bug class).
    "uint8": np.uint8,
    "uint16": np.uint16,
    "uint32": np.uint32,
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "float64": np.float64,
}


def _normalize_to_float(arr: np.ndarray) -> np.ndarray:
    """Integer raw data is normalized to [0,1] like the reference."""
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


@register_loader
class DatRawLoader(VolumeLoader):
    """.dat descriptor + .raw payload (key: value lines)."""

    extensions = ("dat",)

    def open(self, path, dataset_info=None):
        self.path = path
        entries = {}
        with open(path, "r", errors="replace") as f:
            for line in f:
                if ":" not in line:
                    continue
                key, value = line.split(":", 1)
                entries[key.strip().lower()] = value.strip()
        if "objectfilename" not in entries or "resolution" not in entries:
            raise ValueError(f"{path}: missing ObjectFileName/Resolution")
        self._raw_files = entries["objectfilename"].split()
        res = [int(v) for v in entries["resolution"].split()]
        self.xs, self.ys, self.zs = res[0], res[1], res[2]
        if "slicethickness" in entries:
            st = [float(v) for v in entries["slicethickness"].split()]
            self.dx, self.dy, self.dz = st[0], st[1], st[2]
        self._dtype = _DAT_FORMATS[entries.get("format", "float").lower()]
        self.ts = len(self._raw_files) if len(self._raw_files) > 1 else 1
        self.field_names = [
            os.path.splitext(os.path.basename(self._raw_files[0]))[0]
        ]
        self._dir = os.path.dirname(os.path.abspath(path))
        return self

    def load_field(self, name, time=0, member=0):
        raw = self._raw_files[min(time, len(self._raw_files) - 1)]
        raw_path = os.path.join(self._dir, raw)
        data = np.fromfile(raw_path, dtype=self._dtype)
        data = data[: self.xs * self.ys * self.zs].reshape(
            self.zs, self.ys, self.xs
        )
        return _normalize_to_float(data)


@register_loader
class RawLoader(VolumeLoader):
    """Standalone .raw with metadata encoded in the filename
    (``name_XxYxZ_dtype.raw`` convention) or supplied via dataset_info."""

    extensions = ("raw",)

    def open(self, path, dataset_info=None):
        self.path = path
        m = re.search(r"(\d+)x(\d+)x(\d+)", os.path.basename(path))
        if not m:
            raise ValueError(
                f"{path}: cannot infer resolution (expected ..._XxYxZ_...)"
            )
        self.xs, self.ys, self.zs = (int(g) for g in m.groups())
        dtype = np.uint8
        # Longest match wins: 'short' is a substring of 'ushort', so
        # iteration order let the later key overwrite the right one
        # (ushort volumes loaded as int16).
        best = ""
        for key, dt in _DAT_FORMATS.items():
            if key in os.path.basename(path).lower() and len(key) > len(best):
                best, dtype = key, dt
        self._dtype = dtype
        self.field_names = [os.path.splitext(os.path.basename(path))[0]]
        return self

    def load_field(self, name, time=0, member=0):
        data = np.fromfile(self.path, dtype=self._dtype)
        data = data[: self.xs * self.ys * self.zs].reshape(
            self.zs, self.ys, self.xs
        )
        return _normalize_to_float(data)

