"""PyTorch port (``correrender_tpu_torch/diagrams``) vs the JAX
package's JAX-free diagram modules: the SVG canvas, its rasterizer and
overlay composite, the radar bar and scatter charts, the octree and its
downsampling, and DBSCAN, on the same seeded inputs.

The modules are copies (numpy), so their outputs are equal; the two
functions that take tensors (``raster.composite_overlay``,
``octree.downsample_fields``) are held to the JAX functions on the same
arrays.
"""

import numpy as np
import pytest
import torch

from correrender_tpu.diagrams.dbscan import dbscan as jax_dbscan
from correrender_tpu.diagrams import octree as jax_octree
from correrender_tpu.diagrams import radar as jax_radar
from correrender_tpu.diagrams import raster as jax_raster
from correrender_tpu.diagrams import scatter as jax_scatter
from correrender_tpu.diagrams import svg as jax_svg

import correrender_tpu_torch.diagrams as diagrams
from correrender_tpu_torch.diagrams import octree, radar, raster
from correrender_tpu_torch.diagrams import scatter, svg
from correrender_tpu_torch.diagrams.dbscan import dbscan


def canvas_svg(module):
    c = module.SvgCanvas(120, 90)
    c.rect(0, 0, 120, 90, fill=(0.1, 0.1, 0.1), opacity=0.5)
    c.line(5, 5, 100, 80, color=(1, 0, 0), width=2.5)
    c.circle(60, 45, 12, fill="steelblue", stroke="black")
    c.path([(10, 10), (40, 70), (90, 20)], color=(0, 1, 0), width=1.5,
           closed=True)
    c.bezier([(10, 80), (40, 10), (80, 10), (110, 80)], width=2)
    c.arc_ring(60, 45, 20, 35, 0.2, 1.7, fill=(0.9, 0.6, 0.1))
    c.annulus(60, 45, 36, 40, fill="gray")
    c.text(60, 85, "r = 0.5 <&>", size=9)
    return c.to_svg()


def test_svg_text_equals_jax():
    assert canvas_svg(svg) == canvas_svg(jax_svg)


@pytest.mark.parametrize("scale,supersample", [(1.0, 2), (1.5, 3)])
def test_rasterized_svg_equals_jax(scale, supersample):
    text = canvas_svg(jax_svg)
    got = raster.rasterize_svg(text, scale=scale, supersample=supersample)
    want = jax_raster.rasterize_svg(text, scale=scale,
                                    supersample=supersample)
    np.testing.assert_array_equal(got, want)
    assert got[..., 3].max() > 0.5


@pytest.mark.parametrize("anchor,channels,opacity", [
    ("bottom_right", 4, 1.0), ("top_left", 3, 0.6), ("center", 4, 0.8),
    ("bottom_left", 4, 1.0)])
def test_composite_overlay_equals_jax(anchor, channels, opacity):
    rng = np.random.default_rng(1)
    frame = rng.random((70, 110, channels)).astype(np.float32)
    overlay = raster.rasterize_svg(canvas_svg(svg), scale=0.5)
    want = jax_raster.composite_overlay(frame, overlay, anchor=anchor,
                                        opacity=opacity)
    source = torch.from_numpy(frame)
    got = raster.composite_overlay(source, overlay, anchor=anchor,
                                   opacity=opacity)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(source, torch.from_numpy(frame))  # a new tensor
    # An overlay larger than the frame is clipped to fit.
    big = raster.rasterize_svg(canvas_svg(svg), scale=2.0)
    np.testing.assert_array_equal(
        raster.composite_overlay(source, big, anchor=anchor).numpy(),
        jax_raster.composite_overlay(frame, big, anchor=anchor))


@pytest.mark.parametrize("equal_area", [True, False])
def test_radar_svg_equals_jax(equal_area):
    names = ["temperature", "pressure", "humidity", "wind"]
    rng = np.random.default_rng(2)
    out = []
    for module in (radar, jax_radar):
        chart = module.RadarBarChart(equal_area=equal_area)
        chart.set_data_time_independent(names, rng.random(4))
        single = chart.render_svg(size=300)
        chart.set_data_time_dependent(names, rng.random((5, 4)))
        out.append((single, chart.render_svg(size=300)))
        rng = np.random.default_rng(2)
    assert out[0] == out[1]
    assert diagrams.RadarBarChart is radar.RadarBarChart


def test_scatter_svg_equals_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 7, 8)).astype(np.float32)
    b = (0.7 * a + 0.3 * rng.normal(size=a.shape)).astype(np.float32)
    a[0, 0, :3] = np.nan
    kw = dict(labels=("mean", "spread"), size=240, max_points=200, seed=4)
    assert scatter.render_scatter_svg(a, b, **kw) == \
        jax_scatter.render_scatter_svg(a, b, **kw)
    labels = rng.integers(-1, 3, a.size)
    for got, want in zip(
            scatter.scatter_points(a, b, max_points=150, colors=labels),
            jax_scatter.scatter_points(a, b, max_points=150,
                                       colors=labels)):
        np.testing.assert_array_equal(got, want)
    assert scatter.render_scatter_svg(a, b, colors=labels, **kw) == \
        jax_scatter.render_scatter_svg(a, b, colors=labels, **kw)


@pytest.mark.parametrize("mode", ["topdown", "zorder"])
@pytest.mark.parametrize("dims,leaf", [((9, 6, 5), 1), ((16, 16, 8), 2),
                                       ((13, 7, 3), 3)])
def test_octree_leaves_and_paths_equal_jax(mode, dims, leaf):
    got = octree.Octree(*dims, leaf_size=leaf, mode=mode)
    want = jax_octree.Octree(*dims, leaf_size=leaf, mode=mode)
    assert [n.region for n in got.nodes] == [
        octree.GridRegion(**vars(n.region)) for n in want.nodes]
    assert [(n.parent_idx, n.children) for n in got.nodes] == [
        (n.parent_idx, n.children) for n in want.nodes]
    assert len(got.leaves) == len(want.leaves) > 1
    for i in range(len(got.leaves)):
        assert got.leaf_path(i) == want.leaf_path(i)
    with pytest.raises(ValueError, match="unknown octree mode"):
        octree.Octree(*dims, mode="nope")


@pytest.mark.parametrize("factor", [2, (3, 2, 4), 1])
def test_downsample_fields_matches_jax(factor):
    rng = np.random.default_rng(5)
    stack = rng.normal(size=(7, 9, 10, 4)).astype(np.float32)
    stack[:3, :2, :4] = np.nan  # an all-NaN block at factor 2
    stack[5, 5, 5, 1] = np.nan
    want = jax_octree.downsample_fields(stack, factor)
    got = octree.downsample_fields(torch.from_numpy(stack), factor)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    # nanmean's float32 sums in another order.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if factor == 2:
        assert np.isnan(want[0, 0, 0]).all()


@pytest.mark.parametrize("eps,min_samples", [(0.3, 4), (0.6, 8), (0.1, 3)])
def test_dbscan_labels_equal_jax(eps, min_samples):
    rng = np.random.default_rng(6)
    points = np.concatenate([rng.normal(c, 0.15, (60, 2))
                             for c in ((0, 0), (2, 1), (-1, 2))]
                            + [rng.uniform(-3, 4, (20, 2))])
    got = dbscan(points, eps=eps, min_samples=min_samples)
    want = jax_dbscan(points, eps=eps, min_samples=min_samples)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist()) - {-1}) >= 1
    assert diagrams.dbscan is dbscan
    assert dbscan(np.zeros((0, 2))).shape == (0,)
