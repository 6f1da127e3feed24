"""VTK loaders: XML ImageData (.vti) and legacy structured-points (.vtk).

Reference: src/Loaders/VtkXmlLoader.cpp (+ vendored base64 decoder) and
StructuredGridVtkLoader.cpp. Subset supported: ImageData with inline
ascii / base64 / appended raw data arrays (optionally zlib-compressed),
and legacy ASCII/binary STRUCTURED_POINTS scalars.

A copy of ``correrender_tpu/io/vtk.py``: every field decodes to the same
bits.
"""

from __future__ import annotations

import base64
import re
import zlib
import xml.etree.ElementTree as ET

import numpy as np

from correrender_tpu_torch.io.base import VolumeLoader, register_loader

_VTK_DTYPES = {
    "Float32": np.float32,
    "Float64": np.float64,
    "Int8": np.int8,
    "UInt8": np.uint8,
    "Int16": np.int16,
    "UInt16": np.uint16,
    "Int32": np.int32,
    "UInt32": np.uint32,
    "Int64": np.int64,
    "UInt64": np.uint64,
}

_LEGACY_DTYPES = {
    "float": ">f4",
    "double": ">f8",
    "int": ">i4",
    "short": ">i2",
    "unsigned_char": "u1",
    "unsigned_short": ">u2",
    "char": "i1",
}


def _b64_len(nbytes: int) -> int:
    """Length in base64 characters of an ``nbytes``-byte stream."""
    return 4 * ((nbytes + 2) // 3)


def _inflate_blocks(payload, off: int, sizes) -> bytes:
    """The concatenation of zlib blocks of ``sizes`` bytes from ``off``
    (joined once: appending block by block copies the output again each
    time, quadratic in the blocks)."""
    out = []
    for s in sizes:
        out.append(zlib.decompress(payload[off:off + int(s)]))
        off += int(s)
    return b"".join(out)


def _decode_b64_block(data_b64: str, dtype, compressed: bool,
                      header_type=np.uint32):
    text = re.sub(r"\s", "", data_b64)
    hsize = np.dtype(header_type).itemsize
    if compressed:
        # Compressed inline data is TWO separate base64 streams
        # (VtkXmlLoader.cpp): first base64(header) where header =
        # [nblocks, blocksize, lastsize, sizes...], then
        # base64(concatenated compressed blocks). Each stream is padded
        # independently, so the whole text cannot be decoded in one
        # call — b64decode would stop at the header stream's padding.
        first = base64.b64decode(text[: _b64_len(hsize)])
        nblocks = int(np.frombuffer(first[:hsize], header_type)[0])
        header_chars = _b64_len(hsize * (3 + nblocks))
        header = np.frombuffer(
            base64.b64decode(text[:header_chars]), header_type
        )
        sizes = header[3 : 3 + nblocks]
        payload = base64.b64decode(text[header_chars:])
        return np.frombuffer(_inflate_blocks(payload, 0, sizes), dtype)
    # Uncompressed inline data is ONE stream: base64(header + data).
    raw = base64.b64decode(text)
    n = int(np.frombuffer(raw[:hsize], header_type)[0])
    return np.frombuffer(raw[hsize : hsize + n], dtype)


@register_loader
class VtkXmlLoader(VolumeLoader):
    """XML ImageData (.vti) and StructuredGrid (.vts) reader."""

    extensions = ("vti", "vts")

    def open(self, path, dataset_info=None):
        self.path = path
        with open(path, "rb") as f:
            content = f.read()
        self._appended = b""
        self._app_b64 = False
        app_match = re.search(rb"<AppendedData[^>]*>", content)
        if app_match:
            # The VTK library writes base64 appended data by DEFAULT
            # (EncodeAppendedDataOn); treating it as raw bytes read
            # ASCII text as the size header.
            self._app_b64 = b'"base64"' in app_match.group(0)
            start = content.index(b"_", app_match.end()) + 1
            end = content.rindex(b"</AppendedData>")
            self._appended = content[start:end]
            content = (
                content[: app_match.end()] + b"</AppendedData>"
                + content[end + len(b"</AppendedData>"):]
            )
        self._root = ET.fromstring(content.decode("utf-8", "replace"))
        self._compressed = "compressor" in self._root.attrib or bool(
            self._root.get("compressor")
        )
        self._header_type = (
            np.uint64
            if self._root.get("header_type") == "UInt64"
            else np.uint32
        )
        image = self._root.find(".//ImageData")
        if image is None:
            image = self._root.find(".//StructuredGrid")
        if image is None:
            raise ValueError(
                f"{path}: no ImageData/StructuredGrid element"
            )
        extent = [int(v) for v in image.get("WholeExtent").split()]
        self.xs = extent[1] - extent[0] + 1
        self.ys = extent[3] - extent[2] + 1
        self.zs = extent[5] - extent[4] + 1
        spacing = [float(v) for v in (image.get("Spacing") or "1 1 1").split()]
        self.dx, self.dy, self.dz = spacing
        self._arrays = {}
        for da in image.iter("DataArray"):
            name = da.get("Name")
            if name and name != "Points":
                self._arrays[name] = da
        # Structured grids carry explicit point coordinates; derive the
        # mean spacing from the coordinate bounds (curvilinear warping
        # is dropped — fields resample onto the regular index grid, the
        # same simplification the reference's structured-grid loader
        # applies for its volume pipeline).
        pts = image.find(".//Points/DataArray")
        if pts is not None:
            coords = self._decode_array(pts, ncomp_keep=3)
            if coords.size:
                xyz = coords.reshape(-1, 3)
                span = xyz.max(axis=0) - xyz.min(axis=0)
                self.dx = float(span[0]) / max(self.xs - 1, 1) or 1.0
                self.dy = float(span[1]) / max(self.ys - 1, 1) or 1.0
                self.dz = float(span[2]) / max(self.zs - 1, 1) or 1.0
        self.field_names = list(self._arrays)
        return self

    def _decode_array(self, da, ncomp_keep: int | None = None):
        """Decode one DataArray to a flat float32 array (all formats)."""
        arr = self._decode_raw(da)
        ncomp = int(da.get("NumberOfComponents", "1"))
        arr = np.asarray(arr, np.float32)
        if ncomp_keep is not None:
            return arr
        if ncomp > 1:
            arr = arr.reshape(-1, ncomp)[:, 0]
        return arr

    def _decode_raw(self, da):
        dtype = _VTK_DTYPES[da.get("type", "Float32")]
        fmt = da.get("format", "ascii")
        if fmt == "ascii":
            arr = np.array(da.text.split(), dtype=np.float64)
        elif fmt == "binary":
            arr = _decode_b64_block(
                da.text, dtype, self._compressed, self._header_type
            )
        elif fmt == "appended":
            offset = int(da.get("offset", "0"))
            hsize = np.dtype(self._header_type).itemsize
            if self._app_b64:
                if self._compressed:
                    raise ValueError(
                        "base64-encoded compressed appended data is "
                        "not supported; write with raw appended "
                        "encoding or inline binary"
                    )
                # Offsets index the ENCODED stream; each array's
                # [header][data] block is base64-encoded as one unit.
                enc = bytes(self._appended[offset:])
                head = base64.b64decode(enc[: 4 * (-(-hsize // 3))])
                n = int(np.frombuffer(head[:hsize],
                                      self._header_type)[0])
                raw = base64.b64decode(
                    enc[: 4 * (-(-(hsize + n) // 3))]
                )
                arr = np.frombuffer(raw[hsize : hsize + n], dtype)
            elif self._compressed:
                blob = self._appended[offset:]
                nblocks = int(
                    np.frombuffer(blob[:hsize], self._header_type)[0]
                )
                header_len = hsize * (3 + nblocks)
                sizes = np.frombuffer(
                    blob[:header_len], self._header_type
                )[3:]
                arr = np.frombuffer(
                    _inflate_blocks(blob, header_len, sizes), dtype)
            else:
                n = int(
                    np.frombuffer(
                        self._appended[offset : offset + hsize],
                        self._header_type,
                    )[0]
                )
                arr = np.frombuffer(
                    self._appended[offset + hsize : offset + hsize + n], dtype
                )
        else:
            raise ValueError(f"unknown DataArray format {fmt!r}")
        return arr

    def load_field(self, name, time=0, member=0):
        arr = self._decode_array(self._arrays[name])
        return arr[: self.xs * self.ys * self.zs].reshape(
            self.zs, self.ys, self.xs
        )


@register_loader
class LegacyVtkLoader(VolumeLoader):
    """Legacy .vtk STRUCTURED_POINTS scalar fields."""

    extensions = ("vtk",)

    def open(self, path, dataset_info=None):
        self.path = path
        with open(path, "rb") as f:
            self._content = f.read()
        text = self._content[:4096].decode("ascii", "replace")
        m = re.search(r"DIMENSIONS\s+(\d+)\s+(\d+)\s+(\d+)", text)
        if not m:
            raise ValueError(f"{path}: no DIMENSIONS (structured points only)")
        self.xs, self.ys, self.zs = (int(g) for g in m.groups())
        sm = re.search(
            r"SPACING\s+([\d.eE+-]+)\s+([\d.eE+-]+)\s+([\d.eE+-]+)", text
        )
        if sm:
            self.dx, self.dy, self.dz = (float(g) for g in sm.groups())
        self._binary = b"\nBINARY" in self._content[:4096].upper()
        self._fields = {}
        for m in re.finditer(
            rb"SCALARS\s+(\S+)\s+(\S+)", self._content
        ):
            self._fields[m.group(1).decode()] = (
                m.end(),
                m.group(2).decode().lower(),
            )
        self.field_names = list(self._fields)
        return self

    def load_field(self, name, time=0, member=0):
        pos, type_name = self._fields[name]
        n = self.xs * self.ys * self.zs
        # Skip LOOKUP_TABLE line.
        lt = self._content.index(b"LOOKUP_TABLE", pos)
        data_start = self._content.index(b"\n", lt) + 1
        dtype = _LEGACY_DTYPES.get(type_name, ">f4")
        if self._binary:
            arr = np.frombuffer(
                self._content, dtype=dtype, count=n, offset=data_start
            ).astype(np.float32)
        else:
            arr = np.array(
                self._content[data_start:].split(maxsplit=n)[:n],
                dtype=np.float32,
            )
        return arr.reshape(self.zs, self.ys, self.xs)
