"""Binary volume formats: the reference's .dat descriptor + .raw payload,
a standalone .raw named ``name_XxYxZ_dtype.raw``, the MetaImage .mhd
descriptor + raw payload, the group-internal .cvol and GrADS .ctl.

A copy of ``correrender_tpu/io/raw.py`` (reference loaders
DatRawFileLoader, MhdRawFileLoader, CvolLoader and CtlLoader,
src/Loaders/). The .cvol header layout is
``char[4] 'cvol' | 3×u64 size | 3×f64 voxel size | u32 dtype | pad``
with dtype enum {uchar=0, ushort=1, float=2} (CvolLoader.hpp:34-46,
pack(4)).
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


@register_loader
class MhdRawLoader(VolumeLoader):
    """MetaImage .mhd descriptor + raw payload."""

    extensions = ("mhd",)

    _MET_TYPES = {
        "MET_UCHAR": np.uint8,
        "MET_CHAR": np.int8,
        "MET_USHORT": np.uint16,
        "MET_SHORT": np.int16,
        "MET_UINT": np.uint32,
        "MET_INT": np.int32,
        "MET_FLOAT": np.float32,
        "MET_DOUBLE": np.float64,
    }

    def open(self, path, dataset_info=None):
        self.path = path
        entries = {}
        with open(path, "r", errors="replace") as f:
            for line in f:
                if "=" not in line:
                    continue
                key, value = line.split("=", 1)
                entries[key.strip().lower()] = value.strip()
        dims = [int(v) for v in entries["dimsize"].split()]
        self.xs, self.ys, self.zs = dims[0], dims[1], dims[2]
        spacing = entries.get("elementspacing", "1 1 1").split()
        self.dx, self.dy, self.dz = (float(v) for v in spacing[:3])
        self._dtype = self._MET_TYPES[entries.get("elementtype", "MET_FLOAT")]
        self._raw = entries["elementdatafile"]
        self._dir = os.path.dirname(os.path.abspath(path))
        self.field_names = [os.path.splitext(os.path.basename(path))[0]]
        return self

    def load_field(self, name, time=0, member=0):
        data = np.fromfile(
            os.path.join(self._dir, self._raw), dtype=self._dtype
        )
        data = data[: self.xs * self.ys * self.zs].reshape(
            self.zs, self.ys, self.xs
        )
        return _normalize_to_float(data)


_CVOL_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.float32}
_CVOL_DTYPE_IDS = {np.uint8: 0, np.uint16: 1, np.float32: 2}
_CVOL_HEADER = struct.Struct("<4s3q3dIQ")  # magic, sizes, voxel sizes, dtype, pad


@register_loader
class CvolLoader(VolumeLoader):
    """Group-internal .cvol format (CvolLoader.hpp:34-46)."""

    extensions = ("cvol",)

    def open(self, path, dataset_info=None):
        self.path = path
        with open(path, "rb") as f:
            header = f.read(_CVOL_HEADER.size)
        magic, sx, sy, sz, vx, vy, vz, dtype_id, _pad = _CVOL_HEADER.unpack(
            header
        )
        if magic != b"cvol":
            raise ValueError(f"{path}: bad cvol magic {magic!r}")
        self.xs, self.ys, self.zs = int(sx), int(sy), int(sz)
        self.dx, self.dy, self.dz = vx, vy, vz
        self._dtype = _CVOL_DTYPES[dtype_id]
        self.field_names = [os.path.splitext(os.path.basename(path))[0]]
        return self

    def load_field(self, name, time=0, member=0):
        data = np.fromfile(
            self.path, dtype=self._dtype, offset=_CVOL_HEADER.size
        )
        data = data[: self.xs * self.ys * self.zs].reshape(
            self.zs, self.ys, self.xs
        )
        return _normalize_to_float(data)


@register_loader
class CtlLoader(VolumeLoader):
    """GrADS .ctl descriptor (reference: CtlLoader.cpp) — subset:
    DSET/XDEF/YDEF/ZDEF/TDEF/VARS with linear axes and sequential
    float32 binary payload."""

    extensions = ("ctl",)

    def open(self, path, dataset_info=None):
        self.path = path
        self._dir = os.path.dirname(os.path.abspath(path))
        self._vars = []
        lines = open(path, errors="replace").read().splitlines()
        i = 0
        self._big_endian = False
        while i < len(lines):
            parts = lines[i].split()
            i += 1
            if not parts:
                continue
            key = parts[0].lower()
            if key == "dset":
                name = parts[1]
                self._raw = name[1:] if name.startswith("^") else name
            elif key == "options":
                self._big_endian = "big_endian" in [p.lower() for p in parts]
            elif key in ("xdef", "ydef", "zdef"):
                n = int(parts[1])
                setattr(self, {"xdef": "xs", "ydef": "ys", "zdef": "zs"}[key], n)
            elif key == "tdef":
                self.ts = int(parts[1])
            elif key == "vars":
                nv = int(parts[1])
                for j in range(nv):
                    vparts = lines[i + j].split()
                    self._vars.append((vparts[0], int(vparts[1]) or 1))
                i += nv
        self.field_names = [v for v, _ in self._vars]
        return self

    def load_field(self, name, time=0, member=0):
        dtype = ">f4" if self._big_endian else "<f4"
        data = np.fromfile(os.path.join(self._dir, self._raw), dtype=dtype)
        # Sequential layout: per timestep, variables in order, levels each.
        per_t = sum(lv for _, lv in self._vars) * self.ys * self.xs
        offset = time * per_t
        for vname, levels in self._vars:
            size = levels * self.ys * self.xs
            if vname == name:
                arr = data[offset : offset + size].astype(np.float32)
                zs = levels
                out = arr.reshape(zs, self.ys, self.xs)
                if zs != self.zs:
                    full = np.full(
                        (self.zs, self.ys, self.xs), np.nan, np.float32
                    )
                    full[:zs] = out
                    out = full
                return out
            offset += size
        raise KeyError(name)
