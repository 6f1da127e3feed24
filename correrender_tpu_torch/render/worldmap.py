"""World-map ground plane for geo-referenced (lat/lon) data.

Counterpart of ``correrender_tpu/render/worldmap.py`` (the reference's
WorldMapRenderer: an earth-surface plane under lat/lon volumes, textured
with a Natural-Earth raster, WorldMapRenderer.cpp:57-91, or a rasterized
shapefile, ShapefileRasterizer). Without network access the textures
come from a local equirectangular image, a local ESRI shapefile
(:func:`rasterize_shapefile`, a scanline fill) or the procedural
graticule. The texture functions are copies of the JAX package's numpy
code; :func:`world_map_render` draws the plane on the device.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from correrender_tpu_torch.render.camera import rays_in_order


def graticule_texture(
    width: int = 1024,
    height: int = 512,
    spacing_deg: float = 15.0,
    ocean=(0.16, 0.29, 0.42),
    line=(0.8, 0.85, 0.9),
) -> np.ndarray:
    """Procedural lat/lon grid texture (equirectangular)."""
    lon = np.linspace(-180, 180, width)
    lat = np.linspace(90, -90, height)
    glon, glat = np.meshgrid(lon, lat)
    dist_lon = np.abs((glon + 180) % spacing_deg - 0)  # distance to line
    dist_lon = np.minimum(dist_lon, spacing_deg - dist_lon)
    dist_lat = np.abs((glat + 90) % spacing_deg)
    dist_lat = np.minimum(dist_lat, spacing_deg - dist_lat)
    px_deg = 360.0 / width
    on_line = (dist_lon < px_deg) | (dist_lat < 2 * px_deg * 0.5)
    tex = np.empty((height, width, 3), np.float32)
    tex[:] = ocean
    tex[on_line] = line
    return tex


def read_shapefile_polygons(path: str):
    """Minimal ESRI shapefile (.shp) polygon reader.

    Supports shape type 5 (Polygon); returns a list of (N, 2) lon/lat
    rings. Native decoder — no pyshp/GDAL in this image.
    """
    with open(path, "rb") as f:
        header = f.read(100)
        if struct.unpack(">i", header[:4])[0] != 9994:
            raise ValueError(f"{path}: not a shapefile")
        shape_type = struct.unpack("<i", header[32:36])[0]
        if shape_type not in (5, 15, 25):
            raise ValueError(
                f"{path}: unsupported shape type {shape_type} "
                "(polygons only)"
            )
        rings = []
        while True:
            rec_header = f.read(8)
            if len(rec_header) < 8:
                break
            (content_len,) = struct.unpack(">i", rec_header[4:8])
            content = f.read(content_len * 2)
            (stype,) = struct.unpack("<i", content[:4])
            if stype == 0:  # null shape
                continue
            num_parts, num_points = struct.unpack("<2i", content[36:44])
            parts = struct.unpack(
                f"<{num_parts}i", content[44 : 44 + 4 * num_parts]
            )
            pts_off = 44 + 4 * num_parts
            pts = np.frombuffer(
                content[pts_off : pts_off + 16 * num_points], "<f8"
            ).reshape(num_points, 2)
            bounds = list(parts) + [num_points]
            for i in range(num_parts):
                rings.append(pts[bounds[i] : bounds[i + 1]].copy())
        return rings


def rasterize_shapefile(
    path: str,
    width: int = 1024,
    height: int = 512,
    land=(0.35, 0.42, 0.3),
    ocean=(0.16, 0.29, 0.42),
) -> np.ndarray:
    """Scanline-rasterize shapefile polygons into an equirectangular
    texture (ShapefileRasterizer role, even-odd fill)."""
    rings = read_shapefile_polygons(path)
    mask = np.zeros((height, width), bool)
    lat_of_row = np.linspace(90, -90, height)
    for row in range(height):
        lat = lat_of_row[row]
        crossings = []
        for ring in rings:
            x = ring[:, 0]
            y = ring[:, 1]
            x1 = np.roll(x, -1)
            y1 = np.roll(y, -1)
            hit = ((y <= lat) & (y1 > lat)) | ((y1 <= lat) & (y > lat))
            if hit.any():
                t = (lat - y[hit]) / (y1[hit] - y[hit])
                crossings.extend(x[hit] + t * (x1[hit] - x[hit]))
        if not crossings:
            continue
        cols = np.sort(
            ((np.asarray(crossings) + 180.0) / 360.0 * width)
        ).astype(int)
        for a, b in zip(cols[::2], cols[1::2]):
            mask[row, max(a, 0) : min(b, width)] = True
    tex = np.empty((height, width, 3), np.float32)
    tex[:] = ocean
    tex[mask] = land
    return tex


def load_raster_texture(
    path: str,
    lat_range=(-90.0, 90.0),
    lon_range=(-180.0, 180.0),
    source_lat=(-90.0, 90.0),
    source_lon=(-180.0, 180.0),
    max_size: int = 4096,
) -> np.ndarray:
    """Load a local equirectangular raster (PNG/JPEG/(Geo)TIFF) as the
    ground-plane texture — the reference's Natural-Earth raster
    underlay (WorldMapRenderer.cpp:57-91) without its runtime download
    (zero egress here): point it at a local copy of e.g.
    ``NE1_50M_SR_W.tif``.

    Args:
      lat_range/lon_range: the dataset footprint to crop to.
      source_lat/source_lon: the geographic extent the image covers
        (full globe for the Natural-Earth rasters; override for
        regional tiles or use a world file's values).
      max_size: longest output edge (downsampled above it).

    Returns: (H, W, 3) float32 in [0, 1].
    """
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # NE rasters exceed the default
    img = Image.open(path)
    img = img.convert("RGB")
    w, h = img.size

    def frac(value, lo, hi):
        return (value - lo) / (hi - lo)

    # Crop the requested footprint out of the source extent (rows run
    # north → south).
    x0 = int(np.clip(frac(lon_range[0], *source_lon), 0, 1) * w)
    x1 = int(np.ceil(np.clip(frac(lon_range[1], *source_lon), 0, 1) * w))
    y0 = int((1 - np.clip(frac(lat_range[1], *source_lat), 0, 1)) * h)
    y1 = int(np.ceil(
        (1 - np.clip(frac(lat_range[0], *source_lat), 0, 1)) * h
    ))
    x1 = max(x1, x0 + 1)
    y1 = max(y1, y0 + 1)
    img = img.crop((x0, y0, x1, y1))
    cw, ch = img.size
    if max(cw, ch) > max_size:
        scale = max_size / max(cw, ch)
        img = img.resize(
            (max(int(cw * scale), 1), max(int(ch * scale), 1)),
            Image.BILINEAR,
        )
    return np.asarray(img, np.float32) / 255.0


def world_map_render(camera, lat_range=(-90.0, 90.0),
                     lon_range=(-180.0, 180.0), texture=None,
                     plane_height: float = -0.26, image_size=(512, 512),
                     box=None, base_image=None, device=None):
    """Render the textured ground plane under the volume box, behind
    ``base_image`` (or alone on ``device``).

    The plane spans the volume's (x, z) footprint at height
    ``plane_height``; ``texture`` is an ``(H, W, 3)`` numpy array or
    tensor (the graticule by default). ``lat_range`` and ``lon_range``
    are the dataset's extent, which :func:`load_raster_texture` crops
    to; the plane itself does not read them.
    """
    if base_image is not None:
        device = base_image.device
    if texture is None:
        texture = graticule_texture()
    tex = torch.as_tensor(texture, dtype=torch.float32, device=device)
    th, tw = tex.shape[:2]
    if box is None:
        box = (np.array([-0.25, -0.25, -0.25], np.float32),
               np.array([0.25, 0.25, 0.25], np.float32))
    box_min = torch.as_tensor(np.asarray(box[0], np.float32), device=device)
    box_max = torch.as_tensor(np.asarray(box[1], np.float32), device=device)
    extent = box_max - box_min
    width, height = image_size
    origin, directions = rays_in_order(camera, width, height, device=device)
    d_y = directions[..., 1]
    t = (plane_height - origin[1]) / torch.where(d_y.abs() < 1e-9, 1e-9,
                                                  d_y)
    p = origin + directions * t[..., None]
    u = (p[..., 0] - box_min[0]) / extent[0]
    v = (p[..., 2] - box_min[2]) / extent[2]
    in_plane = (t > 0) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)

    def texel(x, n):
        # Clamped before the integer cast, so a ray far off the plane
        # reads an edge texel on every device (it is masked anyway).
        return torch.clamp(torch.nan_to_num(x * (n - 1)), 0,
                           n - 1).to(torch.long)

    rgb = tex[texel(1 - v, th), texel(u, tw)]
    mask = in_plane.to(torch.float32)[..., None]
    if base_image is None:
        base_image = torch.zeros((height, width, 4), dtype=torch.float32,
                                 device=device)
    # The plane is the backdrop: straight-alpha compositing under the
    # frame.
    base_a = base_image[..., 3:4]
    out_rgb = base_image[..., :3] * base_a + (1 - base_a) * mask * rgb
    out_a = torch.maximum(base_a[..., 0], mask[..., 0])
    out_rgb = out_rgb / torch.clamp_min(out_a[..., None], 1e-9)
    return torch.cat([out_rgb, out_a[..., None]], dim=-1)
