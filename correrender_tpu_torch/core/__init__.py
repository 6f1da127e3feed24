"""Core data model: grids, fields, caches."""

from correrender_tpu_torch.core.fields import (
    FieldType,
    GridMetadata,
    VolumeData,
)

__all__ = ["FieldType", "GridMetadata", "VolumeData"]
