"""Volume/field writers: NetCDF3, .cvol, Zarr, mesh .obj/.stl.

A copy of ``correrender_tpu/io/writers.py`` (numpy and scipy). It
departs in one place: ``save_field`` reads the field as a tensor on the
volume's device and copies it to the host.

Reference: src/Export/ (NetCdfWriter, CvolWriter, WriteMesh) reached
through ``VolumeData::saveFieldToFile`` (VolumeData.cpp:2454). Derived
fields exported here reload through the loaders (``io.load_volume``
reads what ``write_netcdf`` writes).
"""

from __future__ import annotations

import os
import struct

import numpy as np


def write_netcdf(path: str, field: np.ndarray, name: str = "data",
                 lat=None, lon=None, height=None):
    """Write (Z, Y, X) / (T, Z, Y, X) / (E, T, Z, Y, X) float32 as
    NetCDF3 classic (readable by the reference's netCDF loader)."""
    import scipy.io

    field = np.asarray(field, np.float32)
    nc = scipy.io.netcdf_file(path, "w")
    try:
        dim_names_all = ("member", "time", "lev", "lat", "lon")
        dim_names = dim_names_all[-field.ndim:]
        for dname, size in zip(dim_names, field.shape):
            nc.createDimension(dname, size)
        for cname, values in (("lat", lat), ("lon", lon), ("lev", height)):
            if values is not None and cname in dim_names:
                var = nc.createVariable(cname, "f", (cname,))
                var[:] = np.asarray(values, np.float32)
        var = nc.createVariable(name, "f", dim_names)
        var[:] = field
    finally:
        nc.close()


_CVOL_HEADER = struct.Struct("<4s3q3dIQ")
_CVOL_IDS = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
             np.dtype(np.float32): 2}


def write_cvol(path: str, field: np.ndarray, voxel_size=(1.0, 1.0, 1.0)):
    """Write (Z, Y, X) volume in the group-internal .cvol format
    (header layout from reference CvolLoader.hpp:34-46)."""
    field = np.asarray(field)
    if field.dtype not in _CVOL_IDS:
        field = field.astype(np.float32)
    zs, ys, xs = field.shape
    header = _CVOL_HEADER.pack(
        b"cvol", xs, ys, zs,
        voxel_size[0], voxel_size[1], voxel_size[2],
        _CVOL_IDS[field.dtype], 0,
    )
    with open(path, "wb") as f:
        f.write(header)
        field.tofile(f)


def write_obj(path: str, vertices: np.ndarray, triangles: np.ndarray,
              normals: np.ndarray | None = None):
    """Wavefront OBJ triangle mesh (reference: Export/WriteMesh.cpp)."""
    with open(path, "w") as f:
        f.write("# correrender_tpu isosurface mesh\n")
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if normals is not None:
            for n in normals:
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for t in triangles:
            a, b, c = int(t[0]) + 1, int(t[1]) + 1, int(t[2]) + 1
            if normals is not None:
                f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
            else:
                f.write(f"f {a} {b} {c}\n")


def write_stl(path: str, vertices: np.ndarray, triangles: np.ndarray):
    """Binary STL triangle mesh."""
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int64)
    tri_pts = vertices[triangles]  # (T, 3, 3)
    n = np.cross(tri_pts[:, 1] - tri_pts[:, 0], tri_pts[:, 2] - tri_pts[:, 0])
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-30), 0.0).astype(np.float32)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(triangles)))
        for i in range(len(triangles)):
            f.write(n[i].tobytes())
            f.write(tri_pts[i].astype(np.float32).tobytes())
            f.write(struct.pack("<H", 0))


def write_tet_mesh(path: str, vertices: np.ndarray,
                   tetrahedra: np.ndarray):
    """Tetrahedral-mesh export as legacy-VTK unstructured grid (ASCII)
    (reference: src/Export/WriteTetMesh.cpp role)."""
    vertices = np.asarray(vertices, np.float32)
    tetrahedra = np.asarray(tetrahedra, np.int64)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("correrender_tpu tet mesh\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(vertices)} float\n")
        for v in vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        f.write(f"CELLS {len(tetrahedra)} {len(tetrahedra) * 5}\n")
        for t in tetrahedra:
            f.write(f"4 {t[0]} {t[1]} {t[2]} {t[3]}\n")
        f.write(f"CELL_TYPES {len(tetrahedra)}\n")
        f.write("\n".join(["10"] * len(tetrahedra)) + "\n")


def voxels_to_tet_mesh(volume: np.ndarray, threshold: float):
    """Tetrahedralize the voxels above a threshold (6 tets per cell) —
    the volumetric-mesh export path complementing the isosurface mesh."""
    zs, ys, xs = volume.shape
    mask = np.asarray(volume) >= threshold
    cells = np.argwhere(
        mask[:-1, :-1, :-1] & mask[1:, :-1, :-1] & mask[:-1, 1:, :-1]
        & mask[:-1, :-1, 1:] & mask[1:, 1:, :-1] & mask[1:, :-1, 1:]
        & mask[:-1, 1:, 1:] & mask[1:, 1:, 1:]
    )
    if len(cells) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 4), np.int64)
    # 6-tet decomposition: the fan {0, c_i, c_{i+1}, 7} around the
    # BODY diagonal 0-7, c walking the edge cycle 1→3→2→6→4→5 (same
    # table as native/isosurface.cpp). The earlier face-diagonal 0-6
    # fan left ~25% of each cell uncovered and double-covered ~25%
    # (Monte-Carlo verified; the marching-tetrahedra path had the same
    # geometry bug, fixed the same way).
    tets_of_cube = np.array(
        [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
         [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]]
    )
    # Corner id c has offsets (x=bit0, y=bit1, z=bit2).
    id_to_zyx = np.array(
        [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)]
    )
    corners = cells[:, None, :] + id_to_zyx[None, :, :]  # (C, 8, 3) zyx
    flat = (
        corners[..., 0] * (ys * xs) + corners[..., 1] * xs + corners[..., 2]
    )  # (C, 8)
    uniq, inverse = np.unique(flat.ravel(), return_inverse=True)
    inverse = inverse.reshape(len(cells), 8)
    vz = uniq // (ys * xs)
    vy = (uniq // xs) % ys
    vx = uniq % xs
    verts = np.stack([vx, vy, vz], axis=-1).astype(np.float32)
    tets = inverse[:, tets_of_cube].reshape(-1, 4)
    return verts, tets


def write_zarr(path: str, field: np.ndarray, chunks=None,
               compressor: str | None = "zlib", attrs=None):
    """Write an array as a Zarr v2 directory store.

    Readable by ``io/zarr_lite.py`` (and any zarr implementation):
    ``.zarray``/``.zattrs`` JSON + C-order chunk files. ``compressor``
    is ``"zlib"`` (spec id "zlib", zlib-deflate of the raw chunk) or
    ``None`` for raw chunks. Beyond reference parity — the reference
    reads zarr via z5 but has no zarr writer.
    """
    import json
    import zlib

    field = np.ascontiguousarray(field)
    if chunks is None:
        # One chunk per leading index, whole trailing volume — the
        # natural layout for (E, T, Z, Y, X) member access.
        chunks = (1,) * max(field.ndim - 3, 0) + field.shape[-3:]
    chunks = tuple(int(c) for c in chunks)
    if len(chunks) != field.ndim:
        raise ValueError(f"chunks rank {len(chunks)} != array rank "
                         f"{field.ndim}")
    os.makedirs(path, exist_ok=True)
    meta = {
        "zarr_format": 2,
        "shape": list(field.shape),
        "chunks": list(chunks),
        "dtype": field.dtype.str,
        "compressor": ({"id": "zlib", "level": 4}
                       if compressor == "zlib" else None),
        "fill_value": None,
        "order": "C",
        "filters": None,
    }
    if compressor not in (None, "zlib"):
        raise ValueError(f"unsupported compressor {compressor!r}")
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    if attrs:
        with open(os.path.join(path, ".zattrs"), "w") as f:
            json.dump(attrs, f)
    grid = [range(0, s, c) for s, c in zip(field.shape, chunks)]
    import itertools

    for starts in itertools.product(*grid):
        idx = tuple(s // c for s, c in zip(starts, chunks))
        block = np.zeros(chunks, field.dtype)
        sel = tuple(slice(s, min(s + c, dim))
                    for s, c, dim in zip(starts, chunks, field.shape))
        sub = field[sel]
        block[tuple(slice(0, n) for n in sub.shape)] = sub
        raw = block.tobytes(order="C")
        if compressor == "zlib":
            raw = zlib.compress(raw, 4)
        with open(os.path.join(path, ".".join(map(str, idx))),
                  "wb") as f:
            f.write(raw)


def save_field(volume_data, field_name: str, path: str,
               time: int = 0, member: int = 0):
    """Export one field slab by extension (.nc / .cvol / .zarr), the
    analogue of VolumeData::saveFieldToFile."""
    arr = volume_data.get_field(field_name, time, member).cpu().numpy()
    if path.endswith(".nc"):
        write_netcdf(path, arr, name=field_name.replace(" ", "_"),
                     lat=getattr(volume_data, "lat", None),
                     lon=getattr(volume_data, "lon", None),
                     height=getattr(volume_data, "height", None))
    elif path.endswith(".cvol"):
        g = volume_data.grid
        write_cvol(path, arr, (g.dx, g.dy, g.dz))
    elif path.endswith(".zarr"):
        write_zarr(path, arr, attrs={"field": field_name})
    else:
        raise ValueError(f"unsupported export extension for {path!r}")
