"""Minimal Zarr v2 store reader (no zarr package needed).

A copy of ``correrender_tpu/io/zarr_lite.py``.

Reference: src/Loaders/ZarrLoader.cpp (via z5/xtensor). Supports
directory stores with ``.zarray``/``.zattrs`` JSON metadata, C-order
chunks, raw / zlib / gzip / blosc compression (blosc frames decoded
natively — io/blosc.py — with lz4/zstd/zlib inner codecs and byte
shuffle).
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

from correrender_tpu_torch.io.base import VolumeLoader, register_loader


class ZarrArray:
    """One zarr v2 array backed by a directory of chunk files."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{path}: only zarr v2 supported")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        fv = meta.get("fill_value", 0)
        if fv is None:  # spec-valid "fill_value": null
            fv = np.nan if np.issubdtype(self.dtype, np.floating) else 0
        self.fill_value = fv
        self.order = meta.get("order", "C")
        comp = meta.get("compressor")
        self.compressor = comp["id"] if comp else None
        if self.compressor not in (None, "zlib", "gzip", "blosc"):
            raise ValueError(
                f"{path}: compressor {self.compressor!r} not supported "
                "(raw/zlib/gzip/blosc)"
            )
        self.sep = meta.get("dimension_separator", ".")

    def _read_chunk(self, idx):
        name = self.sep.join(str(i) for i in idx)
        fp = os.path.join(self.path, name)
        if not os.path.exists(fp):
            return np.full(self.chunks, self.fill_value, self.dtype)
        with open(fp, "rb") as f:
            raw = f.read()
        if self.compressor in ("zlib", "gzip"):
            raw = zlib.decompress(raw, zlib.MAX_WBITS | 32)
        elif self.compressor == "blosc":
            from correrender_tpu_torch.io.blosc import blosc_decompress

            raw = blosc_decompress(raw)
        arr = np.frombuffer(raw, self.dtype)
        if self.order == "F":
            return arr.reshape(self.chunks, order="F")
        return arr.reshape(self.chunks)

    def __getitem__(self, index):
        # Normalize index to one (int-or-slice) per dim.
        if not isinstance(index, tuple):
            index = (index,)
        index = index + (slice(None),) * (len(self.shape) - len(index))
        out_ranges = []
        for dim, ix in enumerate(index):
            if isinstance(ix, int):
                out_ranges.append((ix, ix + 1, True))
            else:
                start, stop, step = ix.indices(self.shape[dim])
                if step != 1:
                    raise ValueError("strided zarr reads not supported")
                out_ranges.append((start, stop, False))
        out_shape = [hi - lo for lo, hi, _ in out_ranges]
        out = np.empty(out_shape, self.dtype)
        # Iterate over intersecting chunks.
        chunk_ranges = [
            range(lo // c, -(-hi // c) if hi > lo else lo // c + 1)
            for (lo, hi, _), c in zip(out_ranges, self.chunks)
        ]

        def rec(dim, idx, out_slices, chunk_slices):
            if dim == len(self.shape):
                chunk = self._read_chunk(idx)
                out[tuple(out_slices)] = chunk[tuple(chunk_slices)]
                return
            lo, hi, _ = out_ranges[dim]
            c = self.chunks[dim]
            for ci in chunk_ranges[dim]:
                c_lo = max(lo, ci * c)
                c_hi = min(hi, (ci + 1) * c)
                if c_lo >= c_hi:
                    continue
                rec(
                    dim + 1,
                    idx + [ci],
                    out_slices + [slice(c_lo - lo, c_hi - lo)],
                    chunk_slices + [slice(c_lo - ci * c, c_hi - ci * c)],
                )

        rec(0, [], [], [])
        squeeze = tuple(
            d for d, (_, _, is_int) in enumerate(out_ranges) if is_int
        )
        return np.squeeze(out, axis=squeeze) if squeeze else out


def open_group(path: str) -> dict[str, ZarrArray]:
    """All arrays in a zarr directory store (group or bare array)."""
    arrays = {}
    if os.path.exists(os.path.join(path, ".zarray")):
        arrays[os.path.basename(path.rstrip("/"))] = ZarrArray(path)
        return arrays
    for entry in sorted(os.listdir(path)):
        sub = os.path.join(path, entry)
        if os.path.isdir(sub) and os.path.exists(
            os.path.join(sub, ".zarray")
        ):
            arrays[entry] = ZarrArray(sub)
    return arrays


@register_loader
class ZarrLoader(VolumeLoader):
    extensions = ("zarr",)

    _COORDS = {"lat", "latitude", "lon", "longitude", "lev", "level",
               "time", "member", "height"}

    def open(self, path, dataset_info=None):
        self.path = path
        self._arrays = open_group(path)
        self._vars = {}
        for name, arr in self._arrays.items():
            if name.lower() in self._COORDS or not 3 <= len(arr.shape) <= 5:
                continue
            self._vars[name] = arr
            shape = arr.shape
            if len(shape) == 3:
                self.zs, self.ys, self.xs = shape
            elif len(shape) == 4:
                self.ts = max(self.ts, shape[0])
                self.zs, self.ys, self.xs = shape[1:]
            else:
                self.es = max(self.es, shape[0])
                self.ts = max(self.ts, shape[1])
                self.zs, self.ys, self.xs = shape[2:]
        if not self._vars:
            raise ValueError(f"{path}: no 3D..5D zarr arrays found")
        self.field_names = list(self._vars)
        for cname, attr in (("lat", "lat"), ("lon", "lon"), ("lev", "height")):
            if cname in self._arrays:
                setattr(self, attr, np.asarray(self._arrays[cname][:]))
        return self

    def load_field(self, name, time=0, member=0):
        arr = self._vars[name]
        if len(arr.shape) == 3:
            out = arr[:]
        elif len(arr.shape) == 4:
            out = arr[time]
        else:
            out = arr[member, time]
        return np.asarray(out, np.float32)
