"""Diagram support (reference L5: src/Renderers/Diagram/), the part of
``correrender_tpu/diagrams`` that needs no JAX, as copies: the 38 named
colormaps, the SVG canvas and its rasterizer, the radar bar and scatter
charts, the octree region hierarchy and DBSCAN. The HEB chart, the
correlation matrix, t-SNE and the time-series charts (ROADMAP A.10) are
not ported yet.
"""

from correrender_tpu_torch.diagrams.octree import Octree, GridRegion
from correrender_tpu_torch.diagrams.dbscan import dbscan
from correrender_tpu_torch.diagrams.colormaps import (
    COLOR_MAP_NAMES,
    colormap_lut,
    get_color_points,
)
from correrender_tpu_torch.diagrams.radar import RadarBarChart

__all__ = [
    "Octree",
    "GridRegion",
    "dbscan",
    "COLOR_MAP_NAMES",
    "colormap_lut",
    "get_color_points",
    "RadarBarChart",
]
