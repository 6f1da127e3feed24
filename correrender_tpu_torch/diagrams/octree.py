"""Octree region hierarchy over a (downsampled) grid.

A copy of ``correrender_tpu/diagrams/octree.py``, except
:func:`downsample_fields`, which takes and returns a tensor on its
device (its callers hold the volume there).
Reference: src/Renderers/Diagram/Octree.{hpp,cpp} — the HEB chart
builds its leaf circle from an octree over the downscaled volume;
top-down subdivision and Z-order (Morton) leaf ordering variants
(Octree.cpp:58,151,252-299).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GridRegion:
    """An axis-aligned voxel box [min, max] (inclusive), reference
    Region.hpp:32."""

    x_min: int
    y_min: int
    z_min: int
    x_max: int
    y_max: int
    z_max: int

    @property
    def size(self):
        return (
            (self.x_max - self.x_min + 1)
            * (self.y_max - self.y_min + 1)
            * (self.z_max - self.z_min + 1)
        )

    @property
    def center(self):
        return (
            0.5 * (self.x_min + self.x_max),
            0.5 * (self.y_min + self.y_max),
            0.5 * (self.z_min + self.z_max),
        )


@dataclasses.dataclass
class OctreeNode:
    region: GridRegion
    children: list
    parent_idx: int
    depth: int


class Octree:
    """Octree over an (xs, ys, zs) grid.

    Two subdivision variants, mirroring the reference
    (Octree.cpp:58,151):

    * ``mode="topdown"`` — midpoint splits of the actual extents
      (buildHebTreeIterativeTopDown);
    * ``mode="zorder"`` — the grid is conceptually padded to the next
      power of two and split with uniform power-of-two cell sizes, so
      leaves follow a true Morton order even on non-pow2 grids
      (buildHebTreeIterativeTopDownZOrder).

    Nodes are stored level-ordered; ``leaves`` are the terminal regions
    in Z-order, which is what the HEB chart lays out on its circle.
    """

    def __init__(self, xs: int, ys: int, zs: int, leaf_size: int = 1,
                 mode: str = "topdown"):
        if mode not in ("topdown", "zorder"):
            raise ValueError(f"unknown octree mode {mode!r}")
        self.xs, self.ys, self.zs = xs, ys, zs
        self.leaf_size = leaf_size
        self.mode = mode
        self.nodes: list[OctreeNode] = []
        root = OctreeNode(
            GridRegion(0, 0, 0, xs - 1, ys - 1, zs - 1), [], -1, 0
        )
        self.nodes.append(root)
        if mode == "zorder":
            max_dim = max(xs, ys, zs)
            pow2 = 1
            while pow2 < max_dim:
                pow2 *= 2
            self._subdivide_zorder(0, max(pow2 // 2, 1))
        else:
            self._subdivide(0)
        self.leaves = [
            n.region for n in self.nodes if not n.children
        ]

    def _subdivide_zorder(self, idx: int, subdiv: int):
        node = self.nodes[idx]
        r = node.region
        sx = r.x_max - r.x_min + 1
        sy = r.y_max - r.y_min + 1
        sz = r.z_max - r.z_min + 1
        if max(sx, sy, sz) <= self.leaf_size or subdiv < 1:
            return
        # Fixed power-of-two cell size (not the extent midpoint): the
        # split plane sits at min + subdiv on each axis.
        for cz in range(2):
            z0 = r.z_min + cz * subdiv
            z1 = min(r.z_min + (cz + 1) * subdiv - 1, r.z_max)
            if z0 > r.z_max:
                continue
            for cy in range(2):
                y0 = r.y_min + cy * subdiv
                y1 = min(r.y_min + (cy + 1) * subdiv - 1, r.y_max)
                if y0 > r.y_max:
                    continue
                for cx in range(2):
                    x0 = r.x_min + cx * subdiv
                    x1 = min(r.x_min + (cx + 1) * subdiv - 1, r.x_max)
                    if x0 > r.x_max:
                        continue
                    child = OctreeNode(
                        GridRegion(x0, y0, z0, x1, y1, z1),
                        [], idx, node.depth + 1,
                    )
                    self.nodes.append(child)
                    child_idx = len(self.nodes) - 1
                    node.children.append(child_idx)
                    self._subdivide_zorder(child_idx, subdiv // 2)

    def _subdivide(self, idx: int):
        node = self.nodes[idx]
        r = node.region
        sx = r.x_max - r.x_min + 1
        sy = r.y_max - r.y_min + 1
        sz = r.z_max - r.z_min + 1
        if max(sx, sy, sz) <= self.leaf_size:
            return
        mx = r.x_min + sx // 2
        my = r.y_min + sy // 2
        mz = r.z_min + sz // 2
        # Z-order child enumeration (z fastest-varying bit last).
        for cz in range(2):
            z0, z1 = (r.z_min, mz - 1) if cz == 0 else (mz, r.z_max)
            if z1 < z0 and sz > 1:
                continue
            if sz == 1:
                z0, z1 = r.z_min, r.z_max
                if cz == 1:
                    continue
            for cy in range(2):
                y0, y1 = (r.y_min, my - 1) if cy == 0 else (my, r.y_max)
                if sy == 1:
                    y0, y1 = r.y_min, r.y_max
                    if cy == 1:
                        continue
                if y1 < y0:
                    continue
                for cx in range(2):
                    x0, x1 = (r.x_min, mx - 1) if cx == 0 else (mx, r.x_max)
                    if sx == 1:
                        x0, x1 = r.x_min, r.x_max
                        if cx == 1:
                            continue
                    if x1 < x0:
                        continue
                    child = OctreeNode(
                        GridRegion(x0, y0, z0, x1, y1, z1),
                        [],
                        idx,
                        node.depth + 1,
                    )
                    self.nodes.append(child)
                    child_idx = len(self.nodes) - 1
                    node.children.append(child_idx)
                    self._subdivide(child_idx)

    def leaf_path(self, leaf_idx: int) -> list[int]:
        """Node indices from root to the given leaf (for HEB bundling)."""
        leaf_nodes = [i for i, n in enumerate(self.nodes) if not n.children]
        idx = leaf_nodes[leaf_idx]
        path = [idx]
        while self.nodes[idx].parent_idx >= 0:
            idx = self.nodes[idx].parent_idx
            path.append(idx)
        return path[::-1]


def downsample_fields(stack: torch.Tensor, factor) -> torch.Tensor:
    """Mean-downsample a (Z, Y, X, n) stack tensor on its device
    (reference computeDownscaledFields, HEBChart.hpp:128), NaN-aware:
    an all-NaN block gives NaN.

    ``factor`` is a scalar or per-axis ``(fz, fy, fx)`` — the
    reference's separate x/y/z downscaling factors."""
    if isinstance(factor, (tuple, list)):
        fz, fy, fx = (max(1, int(v)) for v in factor)
    else:
        fz = fy = fx = max(1, int(factor))
    zs, ys, xs, n = stack.shape
    pz = (-zs) % fz
    py = (-ys) % fy
    px = (-xs) % fx
    if pz or py or px:
        stack = torch.nn.functional.pad(
            stack, (0, 0, 0, px, 0, py, 0, pz), value=float("nan"))
    zs2, ys2, xs2 = (
        stack.shape[0] // fz,
        stack.shape[1] // fy,
        stack.shape[2] // fx,
    )
    blocks = stack.reshape(zs2, fz, ys2, fy, xs2, fx, n)
    return torch.nanmean(blocks, dim=(1, 3, 5))
