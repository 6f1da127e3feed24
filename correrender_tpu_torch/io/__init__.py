"""I/O: volume loaders and the dataset catalog.

Counterpart of ``correrender_tpu/io``. The loader registry maps file
extensions to loaders (src/Volume/VolumeData.hpp:444-446). Ported so
far: Zarr v2 (raw, zlib, gzip and blosc chunks), the .dat + .raw pair
and NetCDF; any other extension raises, naming what is ported.
"""

from correrender_tpu_torch.io.base import (
    VolumeLoader,
    load_volume,
    loader_for_path,
    register_loader,
)
from correrender_tpu_torch.io import netcdf  # noqa: F401  (registers)
from correrender_tpu_torch.io import raw  # noqa: F401
from correrender_tpu_torch.io import zarr_lite  # noqa: F401
from correrender_tpu_torch.io.catalog import (
    DataSetInformation,
    load_catalog,
    open_dataset,
)

__all__ = [
    "VolumeLoader",
    "register_loader",
    "loader_for_path",
    "load_volume",
    "DataSetInformation",
    "load_catalog",
    "open_dataset",
]
