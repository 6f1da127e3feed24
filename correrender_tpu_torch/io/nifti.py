"""NIfTI-1 loader (native header decode; reference vendors nifti1.h).

Reference: src/Loaders/NiftiLoader.cpp. Supports uncompressed and
gzipped .nii with the standard 348-byte header. A copy of
``correrender_tpu/io/nifti.py``.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from correrender_tpu_torch.io.base import VolumeLoader, register_loader

_NIFTI_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}


@register_loader
class NiftiLoader(VolumeLoader):
    extensions = ("nii", "gz")

    def open(self, path, dataset_info=None):
        self.path = path
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            header = f.read(352)
        sizeof_hdr = struct.unpack("<i", header[:4])[0]
        self._endian = "<"
        if sizeof_hdr != 348:
            self._endian = ">"
            sizeof_hdr = struct.unpack(">i", header[:4])[0]
            if sizeof_hdr != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
        e = self._endian
        dim = struct.unpack(e + "8h", header[40:56])
        ndim = dim[0]
        self.xs, self.ys, self.zs = dim[1], dim[2], max(dim[3], 1)
        self.ts = dim[4] if ndim >= 4 and dim[4] > 0 else 1
        datatype = struct.unpack(e + "h", header[70:72])[0]
        self._dtype = _NIFTI_DTYPES.get(datatype)
        if self._dtype is None:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        pixdim = struct.unpack(e + "8f", header[76:108])
        self.dx, self.dy, self.dz = (
            pixdim[1] or 1.0,
            pixdim[2] or 1.0,
            pixdim[3] or 1.0,
        )
        self._vox_offset = int(struct.unpack(e + "f", header[108:112])[0])
        self._scl_slope = struct.unpack(e + "f", header[112:116])[0] or 1.0
        self._scl_inter = struct.unpack(e + "f", header[116:120])[0]
        self.field_names = ["intensity"]
        return self

    def load_field(self, name, time=0, member=0):
        opener = gzip.open if self.path.endswith(".gz") else open
        nvox = self.xs * self.ys * self.zs
        itemsize = np.dtype(self._dtype).itemsize
        with opener(self.path, "rb") as f:
            f.seek(self._vox_offset + time * nvox * itemsize)
            raw = f.read(nvox * itemsize)
        arr = np.frombuffer(raw, dtype=self._dtype).astype(np.float32)
        arr = arr * self._scl_slope + self._scl_inter
        # NIfTI stores x fastest: (x, y, z) Fortran-ish → (z, y, x).
        return arr.reshape(self.zs, self.ys, self.xs)
