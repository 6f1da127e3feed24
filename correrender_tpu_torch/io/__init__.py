"""I/O: volume loaders and the dataset catalog.

Counterpart of ``correrender_tpu/io``. The loader registry maps file
extensions to loaders (src/Volume/VolumeData.hpp:444-446), the same
extensions as the JAX package's: Zarr v2 (raw, zlib, gzip and blosc
chunks), NetCDF (3, and 4 through ``h5py``), .dat/.raw, .mhd, .cvol,
GrADS .ctl, VTK (.vti, .vts, legacy .vtk), AmiraMesh, NIfTI (.nii,
.nii.gz), HDF5 (``h5py``, imported when a file is opened), GRIB2 (bit
unpacking in a native codec built at first use), the Rayleigh-Bénard
.bin and the .field format. ``io.torchscript`` reads the weights of
PyTorch and TorchScript archives; ``io.writers`` writes fields out.
"""

from correrender_tpu_torch.io.base import (
    VolumeLoader,
    load_volume,
    loader_for_path,
    register_loader,
)
from correrender_tpu_torch.io import netcdf  # noqa: F401  (registers)
from correrender_tpu_torch.io import hdf5  # noqa: F401
from correrender_tpu_torch.io import raw  # noqa: F401
from correrender_tpu_torch.io import vtk  # noqa: F401
from correrender_tpu_torch.io import zarr_lite  # noqa: F401
from correrender_tpu_torch.io import nifti  # noqa: F401
from correrender_tpu_torch.io import amira  # noqa: F401
from correrender_tpu_torch.io import grib  # noqa: F401
from correrender_tpu_torch.io import field_file  # noqa: F401
from correrender_tpu_torch.io import rbc  # noqa: F401
from correrender_tpu_torch.io.catalog import (
    DataSetInformation,
    load_catalog,
    open_dataset,
)
from correrender_tpu_torch.io import writers

__all__ = [
    "VolumeLoader",
    "register_loader",
    "loader_for_path",
    "load_volume",
    "DataSetInformation",
    "load_catalog",
    "open_dataset",
    "writers",
]
