"""Diagram/analysis subsystem (reference L5: src/Renderers/Diagram/).

Counterpart of ``correrender_tpu/diagrams``: octree region hierarchies,
HEB chord diagrams with correlation sampling (incl. batched Bayesian
optimization), correlation matrices, scatter plots, t-SNE + DBSCAN
distribution-similarity embeddings, and time-series correlation
heatmaps. The correlations run on the member stack's device; vector
output is SVG, drawn on the host (the reference uses NanoVG/Skia/VKVG
canvases), and rasterized by ``diagrams/raster.py`` for view overlays.
"""

from correrender_tpu_torch.diagrams.octree import Octree, GridRegion
from correrender_tpu_torch.diagrams.heb import HEBChart
from correrender_tpu_torch.diagrams.sampling import (
    SAMPLING_METHODS,
    sample_block_pair_max,
)
from correrender_tpu_torch.diagrams.matrix import correlation_matrix
from correrender_tpu_torch.diagrams.tsne import tsne
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
    "HEBChart",
    "SAMPLING_METHODS",
    "sample_block_pair_max",
    "correlation_matrix",
    "tsne",
    "dbscan",
    "COLOR_MAP_NAMES",
    "colormap_lut",
    "get_color_points",
    "RadarBarChart",
]
