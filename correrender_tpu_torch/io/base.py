"""Loader protocol and registry, and ``load_volume``.

Counterpart of ``correrender_tpu/io/base.py`` (the reference's
``VolumeLoader`` contract, src/Loaders/VolumeLoader.hpp:40-52):
``open()`` reads metadata only (grid dims, field names, time and member
counts); voxel data is read per (field, time, member) when a field is
first accessed, and :class:`~correrender_tpu_torch.core.fields.VolumeData`
uploads it to its device once. Loaders of per-member file series reuse
the first file's metadata.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

_LOADER_REGISTRY: dict[str, type] = {}

#: Extensions the JAX package reads and the port does not yet.
_UNPORTED_EXTENSIONS = ("am", "bin", "ctl", "cvol", "field", "grb", "grb2",
                        "grib", "grib2", "gz", "h5", "he5", "hdf5", "mhd",
                        "nii", "vti", "vtk", "vts")


def register_loader(cls):
    """Class decorator: register under ``cls.extensions``."""
    for ext in cls.extensions:
        _LOADER_REGISTRY[ext.lower()] = cls
    return cls


def loader_for_path(path: str):
    """Instantiate the loader for a file path's extension."""
    base = path.rstrip("/")
    ext = os.path.splitext(base)[1].lstrip(".").lower()
    if not ext and base.endswith(".zarr"):
        ext = "zarr"
    cls = _LOADER_REGISTRY.get(ext)
    if cls is None:
        later = (" (the JAX package reads it; the port not yet, ROADMAP "
                 "A.15)" if ext in _UNPORTED_EXTENSIONS else "")
        raise ValueError(
            f"no loader for extension {ext!r} (path {path!r}){later}; "
            f"ported: {sorted(_LOADER_REGISTRY)}")
    return cls()


class VolumeLoader:
    """Base loader: subclasses fill the metadata attributes in open()."""

    extensions: tuple = ()

    def __init__(self):
        self.path: Optional[str] = None
        self.xs = self.ys = self.zs = 0
        self.ts = 1
        self.es = 1
        self.dx = self.dy = self.dz = 1.0
        self.field_names: list[str] = []
        self.lat = None
        self.lon = None
        self.height = None

    # -- protocol --------------------------------------------------------

    def open(self, path: str, dataset_info=None) -> "VolumeLoader":
        raise NotImplementedError

    def load_field(self, name: str, time: int = 0,
                   member: int = 0) -> np.ndarray:
        """Return one (Z, Y, X) float32 slab."""
        raise NotImplementedError

    # -- helpers ---------------------------------------------------------

    def apply_transforms(self, arr: np.ndarray,
                         dataset_info=None) -> np.ndarray:
        """Catalog transforms: subselection, subsampling, format cast and
        axis permutation (DataSetList.cpp:60-305)."""
        if dataset_info is None:
            return arr
        info = dataset_info
        if info.domain_subselection is not None:
            (x0, y0, z0), (x1, y1, z1) = info.domain_subselection
            arr = arr[z0:z1 + 1, y0:y1 + 1, x0:x1 + 1]
        f = info.subsampling_factor
        if f and f > 1:
            arr = arr[::f, ::f, ::f]
        if info.format_cast is not None:
            arr = arr.astype(info.format_cast).astype(np.float32)
        if info.axes is not None and list(info.axes) != [0, 1, 2]:
            # `axes` is in world (x, y, z) order; slabs are (z, y, x).
            p = list(info.axes)
            arr = np.transpose(arr, [2 - p[2 - j] for j in range(3)])
        return arr

    def grid_metadata(self, dataset_info=None):
        from correrender_tpu_torch.core.fields import GridMetadata

        xs, ys, zs = self.xs, self.ys, self.zs
        dx, dy, dz = self.dx, self.dy, self.dz
        if dataset_info is not None:
            f = dataset_info.subsampling_factor
            if dataset_info.domain_subselection is not None:
                (x0, y0, z0), (x1, y1, z1) = dataset_info.domain_subselection
                xs, ys, zs = x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1
            if f and f > 1:
                xs, ys, zs = -(-xs // f), -(-ys // f), -(-zs // f)
                dx, dy, dz = dx * f, dy * f, dz * f
            if dataset_info.scale is not None:
                # The catalog scale multiplies the grid spacing
                # (ZarrLoader.cpp:225-227), not the values.
                sx, sy, sz = dataset_info.scale
                dx, dy, dz = dx * sx, dy * sy, dz * sz
            if (dataset_info.axes is not None
                    and list(dataset_info.axes) != [0, 1, 2]):
                p = list(dataset_info.axes)
                dims = [xs, ys, zs]
                spac = [dx, dy, dz]
                xs, ys, zs = dims[p[0]], dims[p[1]], dims[p[2]]
                dx, dy, dz = spac[p[0]], spac[p[1]], spac[p[2]]
        hs = 1.0
        if dataset_info is not None and dataset_info.height_scale:
            # heightscale stretches the rendered y geometry only
            # (MainApp.cpp:2001-2003).
            hs = float(dataset_info.height_scale)
        return GridMetadata(xs=xs, ys=ys, zs=zs, ts=self.ts, es=self.es,
                            dx=dx, dy=dy, dz=dz, render_height_scale=hs)


def _series_counts(paths, first, dataset_info):
    """(ts, es) of a file series (VolumeData.cpp:663-673)."""
    es, ts = first.es, first.ts
    if len(paths) > 1:
        if dataset_info is not None and dataset_info.time_steps:
            ts = dataset_info.time_steps_count
        if first.es > 1:
            if ts > 1 and len(paths) == ts and first.ts == 1:
                es = first.es  # one file a time step, members inside
            else:
                es = first.es * len(paths)  # member groups per file
        elif first.ts > 1:
            es = len(paths)  # one member a file, time steps inside
        else:
            es = max(len(paths) // max(ts, 1), 1)
    return ts, es


def load_volume(paths, dataset_info=None, cache_bytes=None, device="cuda"):
    """Open file(s) and wire them into a
    :class:`~correrender_tpu_torch.core.fields.VolumeData` on ``device``.

    Mirrors ``VolumeData::setInputFiles`` (VolumeData.cpp:645-747): a
    single path gives one loader; a list of paths is a per-member (or
    per-time-step) file series with metadata reuse. A 2-byte float
    ``format_cast`` gives bfloat16 member stacks; a catalog ``transform``
    sets the volume's model matrix. Fields named u, v, w (or U, V, W)
    get the vector-magnitude, vorticity and helicity calculators
    (VolumeData.cpp:715-747), as in the JAX package.
    """
    from correrender_tpu_torch.core.fields import VolumeData

    if isinstance(paths, (str, os.PathLike)):
        paths = [str(paths)]
    paths = [str(p) for p in paths]

    loaders = []
    for p in paths:
        ld = loader_for_path(p)
        ld.open(p, dataset_info)
        loaders.append(ld)
    first = loaders[0]

    ts, es = _series_counts(paths, first, dataset_info)
    per_file_es, per_file_ts = first.es, first.ts
    grid = dataclasses.replace(first.grid_metadata(dataset_info), ts=ts,
                               es=es)
    member_dtype = None
    cast = getattr(dataset_info, "format_cast", None)
    if (cast is not None and np.dtype(cast).itemsize == 2
            and np.issubdtype(np.dtype(cast), np.floating)):
        # A float16 format_cast gives bfloat16 member stacks (half the
        # residency). Integer casts stay exact in float32: bfloat16's
        # 8-bit significand would merge their levels.
        member_dtype = torch.bfloat16
    vd = VolumeData(grid, cache_bytes=cache_bytes,
                    member_stack_dtype=member_dtype, device=device)
    if getattr(dataset_info, "transform", None) is not None:
        vd.model_matrix = np.asarray(dataset_info.transform, np.float32)
    vd.loaders = loaders
    vd.lat, vd.lon, vd.height = first.lat, first.lon, first.height

    def make_provider(name):
        def provider(t, e):
            if len(loaders) > 1:
                if per_file_es > 1:
                    if ts > 1 and len(loaders) == ts and per_file_ts == 1:
                        arr = loaders[t].load_field(name, 0, e)
                    else:
                        arr = loaders[e // per_file_es].load_field(
                            name, t, e % per_file_es)
                elif per_file_ts > 1:
                    arr = loaders[e].load_field(name, t, 0)
                else:
                    ld = loaders[e] if ts == 1 else loaders[e * ts + t]
                    arr = ld.load_field(name, 0, 0)
            else:
                arr = first.load_field(name, t, e)
            arr = first.apply_transforms(arr, dataset_info)
            return np.ascontiguousarray(arr, np.float32)

        return provider

    for name in first.field_names:
        vd.add_field(name, make_provider(name))
    _auto_register_velocity(vd)
    return vd


def _auto_register_velocity(vd):
    """u/v/w (or U/V/W, whichever comes first) present → register the
    velocity-derived calculators (VolumeData.cpp:715-747)."""
    names = set(vd.field_names)
    for u, v, w in (("u", "v", "w"), ("U", "V", "W")):
        if {u, v, w} <= names:
            from correrender_tpu_torch.calculators.velocity import (
                HelicityCalculator,
                VelocityMagnitudeCalculator,
                VorticityCalculator,
            )

            for cls in (VelocityMagnitudeCalculator, VorticityCalculator,
                        HelicityCalculator):
                vd.add_calculator(cls(u=u, v=v, w=w))
            return
