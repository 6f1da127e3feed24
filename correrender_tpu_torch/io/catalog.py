"""datasets.json scene catalog — schema-compatible with the reference.

A copy of ``correrender_tpu/io/catalog.py``, opening entries on a device.

Reference: src/Loaders/DataSetList.{hpp,cpp} (keys parsed at
DataSetList.cpp:60-305). The catalog is a JSON tree::

    {"datasets": [
        {"type": "node", "name": "group", "children": [...]},
        {"name": "My Set", "filename": "path/f_%04d.nc",
         "ensemble_range": "0 20", "scale": 0.001,
         "subsampling_factor": 2, "format_cast": "float16", ...}
    ]}

printf-style ``%d`` patterns expand over ``ensemble_range`` /
``time_range`` ("start stop [step]", exclusive by default).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

_FORMAT_CASTS = {
    "byte": np.int8,
    "ubyte": np.uint8,
    "short": np.int16,
    "ushort": np.uint16,
    "float": np.float32,
    "float16": np.float16,
    "half": np.float16,
}


@dataclasses.dataclass
class DataSetInformation:
    """Per-dataset catalog entry (DataSetList.hpp:45-112 analogue)."""

    name: str = ""
    filenames: list = dataclasses.field(default_factory=list)
    time_steps: Optional[list] = None
    scale: Optional[tuple] = None  # per-axis (sx, sy, sz) grid-spacing scale
    height_scale: Optional[float] = None
    axes: Optional[list] = None
    transform: Optional[list] = None  # 4x4 row-major
    subsampling_factor: int = 1
    domain_subselection: Optional[tuple] = None  # ((x0,y0,z0),(x1,y1,z1))
    format_cast: Optional[object] = None
    standard_scalar_field: Optional[str] = None
    standard_time_step: int = 0
    separate_files_per_attribute: bool = False
    reuse_metadata: bool = True
    velocity_field_name: Optional[str] = None
    attribute_names: list = dataclasses.field(default_factory=list)
    date: Optional[str] = None
    time: Optional[str] = None
    data_time: Optional[str] = None  # GRIB analysis-time filter

    @property
    def time_steps_count(self) -> int:
        return len(self.time_steps) if self.time_steps else 1


def _expand_range(patterns, range_str, exclusive=True):
    parts = str(range_str).split()
    start, stop = int(parts[0]), int(parts[1])
    step = int(parts[2]) if len(parts) == 3 else 1
    end = stop if exclusive else stop + 1
    indices = list(range(start, end, step))
    files = []
    for pattern in patterns:
        if "%" in pattern:
            files.extend(pattern % i for i in indices)
        else:
            files.append(pattern)
    return files, indices


def _parse_entry(node: dict, base_dir: str, prefix: str) -> DataSetInformation:
    info = DataSetInformation(name=prefix + node.get("name", ""))
    raw = node.get("filenames", node.get("filename", []))
    if isinstance(raw, str):
        raw = raw.split(";") if ";" in raw else [raw]
    info.filenames = [
        f if os.path.isabs(f) else os.path.join(base_dir, f) for f in raw
    ]
    exclusive = True
    if "range_exclusive" in node:
        exclusive = bool(node["range_exclusive"])
    elif "range_inclusive" in node:
        exclusive = not bool(node["range_inclusive"])
    if "ensemble_range" in node:
        info.filenames, _ = _expand_range(
            info.filenames, node["ensemble_range"], exclusive
        )
    elif "time_range" in node:
        info.filenames, info.time_steps = _expand_range(
            info.filenames, node["time_range"], exclusive
        )
    if "time" in node:
        info.time = str(node["time"])
    if "scale" in node:
        # Scalar or per-axis array, scaling the GRID SPACING like the
        # reference (DataSetList.cpp:242-252; consumed as dx/dy/dz
        # multipliers by its loaders).
        v = node["scale"]
        if isinstance(v, (list, tuple)):
            info.scale = tuple(float(c) for c in v)
        else:
            info.scale = (float(v),) * 3
    if "heightscale" in node:
        info.height_scale = float(node["heightscale"])
    if "axes" in node:
        info.axes = list(node["axes"])
    if "transform" in node:
        # 4×4 row-major model matrix: 16 whitespace-separated floats
        # (the reference parses an sgl transform string) or a nested
        # list.
        t = node["transform"]
        if isinstance(t, str):
            vals = [float(v) for v in t.replace(",", " ").split()]
        else:
            vals = list(np.asarray(t, np.float32).reshape(-1))
        if len(vals) != 16:
            raise ValueError(
                f"transform needs 16 matrix entries, got {len(vals)}"
            )
        info.transform = np.asarray(vals, np.float32).reshape(4, 4)
    if "subsampling_factor" in node:
        info.subsampling_factor = int(node["subsampling_factor"])
    if "domain_subselection_min" in node and "domain_subselection_max" in node:
        lo = [int(v) for v in str(node["domain_subselection_min"]).split()]
        hi = [int(v) for v in str(node["domain_subselection_max"]).split()]
        info.domain_subselection = (tuple(lo), tuple(hi))
    if "format_cast" in node:
        info.format_cast = _FORMAT_CASTS[str(node["format_cast"]).lower()]
    if "standard_scalar_field" in node:
        info.standard_scalar_field = node["standard_scalar_field"]
    if "standard_time_step" in node:
        info.standard_time_step = int(node["standard_time_step"])
    if "separate_files_per_attribute" in node:
        info.separate_files_per_attribute = bool(
            node["separate_files_per_attribute"]
        )
    if "reuse_metadata" in node:
        info.reuse_metadata = bool(node["reuse_metadata"])
    if "velocity_field_name" in node:
        info.velocity_field_name = node["velocity_field_name"]
    if "attributes" in node:
        attrs = node["attributes"]
        info.attribute_names = (
            list(attrs) if isinstance(attrs, list) else [attrs]
        )
    if "data_date" in node:
        info.date = str(node["data_date"])
    if "data_time" in node:
        # Paired with data_date: selects the GRIB message time
        # (DataSetList.cpp:235-240; consumed by GribLoader's
        # dataDate/dataTime filter). Own field — the generic "time"
        # key is a separate, non-numeric concept.
        info.data_time = str(node["data_time"])
    return info


def load_catalog(path: str) -> list[DataSetInformation]:
    """Flatten a datasets.json tree into catalog entries.

    Group nodes (``"type": "node"`` with ``children``) contribute their
    name as a ``group/`` prefix, mirroring the reference's hierarchy.
    """
    with open(path) as f:
        doc = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))
    out: list[DataSetInformation] = []

    def walk(nodes, prefix):
        for node in nodes:
            if node.get("type") == "node" or "children" in node:
                sub = node.get("name", "")
                walk(
                    node.get("children", []),
                    prefix + sub + "/" if sub else prefix,
                )
            else:
                out.append(_parse_entry(node, base_dir, prefix))

    walk(doc.get("datasets", []), "")
    return out


def open_dataset(info: DataSetInformation, cache_bytes=None, device="cuda"):
    """Open a catalog entry as a :class:`VolumeData` on ``device``."""
    from correrender_tpu_torch.io.base import load_volume

    return load_volume(info.filenames, info, cache_bytes=cache_bytes,
                       device=device)
