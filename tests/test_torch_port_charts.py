"""PyTorch port (``correrender_tpu_torch``) vs the JAX package: the
charts beside the HEB diagram — the correlation matrix, t-SNE, the
distribution-similarity pipeline, the time-series heatmaps — and the
Scene's diagram family: ``render_diagram`` for the five diagram types,
the overlays composited into ``render_view`` frames, and
``render_dock``.

The same seeded numpy inputs go through both packages. Bars: Pearson
2e-5 and the other measures' bars of ``test_torch_port_heb.py``; the
t-SNE initial embedding bit for bit; overlays within 1e-6 per channel.
The diagram frames compare views without 3D content, whose frame is the
composited overlay itself; beside a DVR pass (which holds JAX's frame
within ``test_torch_port_scene.py``'s 1e-2, not 1e-6) the overlay is
held to JAX's raster composited over the port's own 3D frame.

t-SNE's step (learning rate 200 under 12× exaggeration) is unstable for
a few hundred points: the embedding grows from 1e-4 to ~10 within two
iterations, and from then on any rounding difference grows by about an
order of magnitude an iteration (the port on 1 and on 8 CPU threads
differs by 0.05 after 20 iterations on the box stack's features). The
embedding is held to JAX's at its draw and after one iteration;
distribution-similarity frames are compared at the initial embedding
(ROADMAP C).
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu.app.state import Scene as JaxScene
from correrender_tpu.core.fields import GridMetadata as JaxGrid
from correrender_tpu.core.fields import VolumeData as JaxVolumeData
from correrender_tpu.diagrams import distribution_similarity as jax_ds
from correrender_tpu.diagrams import matrix as jax_matrix
from correrender_tpu.diagrams import timeseries as jax_ts
from correrender_tpu.diagrams.tsne import tsne as jax_tsne
from correrender_tpu.io import writers as jax_writers
from correrender_tpu.utils import fixtures as jfixtures

from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.diagrams import distribution_similarity as ds
from correrender_tpu_torch.diagrams import matrix, timeseries
from correrender_tpu_torch.diagrams.tsne import tsne, tsne_initial
from correrender_tpu_torch.models.mine import MineEstimator, train_mine_batched

BARS = {"pearson": 2e-5, "spearman": 2e-6, "kendall": 1e-6,
        "mi_binned": 1e-5, "mi_kraskov": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: under the tier-1 command (six xdist workers on
    eight cores) the batched GP-UCB's small products ran 30x slower on
    every core than alone on one."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def box_stack():
    data = jfixtures.synth_box_ensemble(xs=32, ys=32, zs=8, members=64)
    return np.ascontiguousarray(np.moveaxis(data, 0, -1))  # (8, 32, 32, 64)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def blobs(seed=0, n=60, dim=10):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(c, 0.3, size=(n, dim))
                           for c in (0.0, 5.0)]).astype(np.float32)


# -- the correlation matrix -----------------------------------------------


@pytest.mark.parametrize("measure", list(BARS))
def test_correlation_matrix_matches_jax(measure):
    rng = np.random.default_rng(0)
    series = rng.normal(size=(5, 120)).astype(np.float32)
    series[3] = series[0] + 0.1 * series[3]
    for symmetric in (True, False):
        got = matrix.correlation_matrix(t(series), measure,
                                        symmetric=symmetric)
        want = jax_matrix.correlation_matrix(series, measure,
                                             symmetric=symmetric)
        assert isinstance(got, torch.Tensor) and got.shape == (5, 5)
        np.testing.assert_allclose(got.numpy(), want, atol=BARS[measure])


def test_matrix_svg_equals_jax(tmp_path):
    m = np.array([[1.0, -0.5, np.nan], [-0.5, 1.0, 0.25],
                  [np.nan, 0.25, 1.0]], np.float32)
    for kw in ({}, {"labels": ["a", "b", "c"], "colormap": "Viridis"}):
        got = matrix.render_matrix_svg(t(m), size=300, **kw)
        assert got == jax_matrix.render_matrix_svg(m, size=300, **kw)
    matrix.render_matrix_svg(m, path=str(tmp_path / "m.svg"))
    assert (tmp_path / "m.svg").read_text().startswith("<svg")


def volumes(fields: dict):
    """A JAX and a port VolumeData serving the same (E, T, Z, Y, X)
    arrays per name."""
    first = next(iter(fields.values()))
    es, ts, zs, ys, xs = first.shape
    grid = dict(xs=xs, ys=ys, zs=zs, ts=ts, es=es)
    jvd = JaxVolumeData(JaxGrid(**grid))
    tvd = VolumeData(GridMetadata(**grid), device="cpu")
    for name, data in fields.items():
        jvd.add_field(name, lambda tt, e, d=data: jnp.asarray(d[e, tt]))
        tvd.add_field(name, lambda tt, e, d=data: d[e, tt])
    return jvd, tvd


def ensemble(seed=0, shape=(12, 6, 8, 16, 16)):
    """(E, T, Z, Y, X) float32 with a shared signal."""
    rng = np.random.default_rng(seed)
    e, tt, z, y, x = shape
    base = rng.normal(size=(tt, z, y, x))
    return np.stack([np.roll(base, k, axis=1) + 0.6 * rng.normal(
        size=base.shape) for k in range(e)]).astype(np.float32)


def test_field_correlation_matrix_matches_jax():
    a = ensemble(0)
    jvd, tvd = volumes({"a": a, "b": 0.5 * a + ensemble(1),
                        "c": ensemble(2)})
    for kw in ({}, {"measure": "spearman", "time": 1,
                    "sample_voxels": 300, "seed": 4}):
        got, names = matrix.field_correlation_matrix(tvd, **kw)
        want, jnames = jax_matrix.field_correlation_matrix(jvd, **kw)
        assert names == jnames == ["a", "b", "c"]
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=BARS[kw.get("measure", "pearson")])


# -- t-SNE ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_tsne_initial_embedding_is_jaxs_to_the_bit(box_stack, seed):
    feats, _ = jax_ds.build_features(box_stack, max_points=150)
    got = tsne(t(feats), num_iters=0, seed=seed).numpy()
    want = jax_tsne(feats, num_iters=0, seed=seed)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(tsne_initial(len(feats), seed), got)


@pytest.mark.parametrize("which", ["box", "blobs"])
def test_tsne_first_step_matches_jax(box_stack, which):
    if which == "box":
        feats, _ = jax_ds.build_features(box_stack, max_points=400)
    else:
        feats = blobs()
    got = tsne(t(feats), num_iters=1).numpy()
    want = jax_tsne(feats, num_iters=1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_tsne_is_unstable_in_both_packages(box_stack):
    # Two iterations take the 1e-4 draw to ~10 in both packages, and the
    # port on one CPU thread and on several already differs after 20
    # (ROADMAP C): the reason no bar holds at 50 iterations.
    feats, _ = jax_ds.build_features(box_stack, max_points=400)
    assert np.abs(jax_tsne(feats, num_iters=2)).max() > 1.0
    assert float(tsne(t(feats), num_iters=2).abs().max()) > 1.0


def test_tsne_separates_two_blobs():
    emb = tsne(t(blobs(n=60)), perplexity=15, num_iters=500).numpy()
    assert emb.shape == (120, 2)
    labels = np.array([0] * 60 + [1] * 60)
    d = np.linalg.norm(emb[:, None] - emb[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert (labels[np.argmin(d, axis=1)] == labels).mean() > 0.95


# -- distribution similarity ----------------------------------------------


@pytest.mark.parametrize("mode", ds.FEATURE_MODES)
@pytest.mark.parametrize("pattern", ["plastic", "all"])
def test_features_match_jax(box_stack, mode, pattern):
    stack = box_stack[:4, :8] if pattern == "all" else box_stack
    got, gid = ds.build_features(t(stack), mode, max_points=150,
                                 pattern=pattern)
    want, wid = jax_ds.build_features(stack, mode, max_points=150,
                                      pattern=pattern)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(gid, wid)


def test_features_drop_nan_cells_as_jax(box_stack):
    stack = box_stack.copy()
    stack[:, :4, :, 3] = np.nan
    for mode in ("cell_member_values", "member_cell_values"):
        got, gid = ds.build_features(t(stack), mode, max_points=150)
        want, wid = jax_ds.build_features(stack, mode, max_points=150)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(gid, wid)
    assert np.array_equal(ds.sample_cells((4, 5, 6), 50),
                          jax_ds.sample_cells((4, 5, 6), 50))
    with pytest.raises(ValueError, match="pattern"):
        ds.sample_cells((8, 8, 8), 10, pattern="grid")


def test_distribution_similarity_matches_jax(box_stack):
    for iters in (0, 1):
        emb, labels, ids = ds.distribution_similarity(
            t(box_stack), max_points=400, num_iters=iters)
        jemb, jlabels, jids = jax_ds.distribution_similarity(
            box_stack, max_points=400, num_iters=iters)
        np.testing.assert_allclose(emb, jemb, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(ids, jids)
        if iters == 0:
            np.testing.assert_array_equal(labels, jlabels)
    emb, labels, ids = ds.distribution_similarity(
        t(box_stack), max_points=150, perplexity=10, num_iters=60)
    assert emb.shape == (len(ids), 2) and len(labels) == len(emb)


# -- time series ----------------------------------------------------------


def _series():
    rng = np.random.default_rng(2)
    tt = np.linspace(0, 8 * np.pi, 200)
    return (np.stack([np.sin(tt), np.sin(tt), np.cos(tt), np.sin(2 * tt)])
            + 0.05 * rng.normal(size=(4, 200))).astype(np.float32)


@pytest.mark.parametrize("measure", list(BARS))
def test_time_series_pairwise_and_lagged_match_jax(measure):
    s = _series()
    got = timeseries.time_series_correlation(t(s), measure)
    want = jax_ts.time_series_correlation(s, measure)
    np.testing.assert_allclose(got.numpy(), want, atol=BARS[measure])
    got = timeseries.time_series_correlation(t(s), measure, window=150)
    want = jax_ts.time_series_correlation(s, measure, window=150)
    assert got.shape == want.shape == (4, 51)
    np.testing.assert_allclose(got.numpy(), want, atol=BARS[measure])


def test_time_series_neural_estimator():
    s = _series()[:3, :64]
    got = timeseries.time_series_correlation(t(s), estimator="mine",
                                             steps=20, hidden=8)
    assert got.shape == (3, 3) and torch.equal(got, got.T)
    # The port's heatmap is train_mine_batched on the normalized upper
    # triangle (JAX draws its nets from jax.random keys, so the two
    # packages' nets differ).
    norm = (t(s) - t(s).mean(1, keepdim=True)) / (
        t(s).std(1, unbiased=False, keepdim=True) + 1e-8)
    iu, ju = np.triu_indices(3)
    want = train_mine_batched(MineEstimator.create(hidden=8, num_layers=3),
                              norm[iu], norm[ju], steps=20)
    np.testing.assert_array_equal(got[iu, ju].numpy(), want.numpy())
    with pytest.raises(ValueError, match="pairwise"):
        timeseries.time_series_correlation(t(s), estimator="mine",
                                           window=10)


def test_time_series_loader_and_heatmap_svg_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    ok = str(tmp_path / "ok.nc")
    jax_writers.write_netcdf(ok, rng.normal(size=(6, 1, 40)).astype(
        np.float32), name="series")
    np.testing.assert_array_equal(timeseries.load_time_series(ok),
                                  jax_ts.load_time_series(ok))
    one = str(tmp_path / "one.nc")
    jax_writers.write_netcdf(one, rng.normal(size=(1, 40)).astype(
        np.float32), name="series")
    assert timeseries.load_time_series(one).shape == (1, 40)
    vol = str(tmp_path / "vol.nc")
    jax_writers.write_netcdf(vol, rng.normal(size=(5, 2, 4, 6, 6)).astype(
        np.float32), name="f")
    with pytest.raises(ValueError, match="2-D series"):
        timeseries.load_time_series(vol)
    m = np.array(jax_ts.time_series_correlation(_series(), window=150))
    m[1, 3] = np.nan
    for kw in ({}, {"colormap": "Cividis", "domain": (0.0, 1.0)}):
        assert timeseries.render_heatmap_svg(t(m), size=256, **kw) == \
            jax_ts.render_heatmap_svg(m, size=256, **kw)


# -- the Scene's diagram family -------------------------------------------

IMAGE = (160, 120)

#: One node of each diagram type, sized for the CPU. t-SNE runs no
#: iteration (see the module docstring).
NODES = {
    "diagram": {"downsample": 8, "max_chords": 30},
    "scatter_plot": {"field_b": "b", "point_size": 1.5},
    "correlation_matrix": {"measure": "spearman"},
    "distribution_similarity": {"max_points": 120, "tsne_num_iters": 0},
    "time_series_correlation": {"color_map": "Viridis"},
}


def scenes(nodes, with_dvr=False):
    a = ensemble(0)
    jvd, tvd = volumes({"a": a, "b": 0.5 * a + ensemble(1)})
    js, ts = JaxScene(jvd), Scene(tvd)
    for sc in (js, ts):
        if with_dvr:
            sc.add_renderer("dvr", field="a")
        for kind, settings in nodes:
            sc.renderers.append({"type": kind, "view": 0, "field": "a",
                                 **settings})
    return js, ts


@pytest.mark.parametrize("kind", list(NODES))
def test_scene_diagram_svg_equals_jax(kind):
    js, ts = scenes([(kind, NODES[kind])], with_dvr=False)
    node = ts.renderers[-1]
    got = ts.render_diagram(node, size=300)
    want = js.render_diagram(dict(node), size=300)
    if kind == "diagram":
        # Chord styles print the values' float digits.
        assert got.count("<path") == want.count("<path")
    else:
        assert got == want


@pytest.mark.parametrize("kind", list(NODES))
def test_scene_overlay_frame_matches_jax(kind):
    js, ts = scenes([(kind, NODES[kind])])
    got = ts.render_view(0, image_size=IMAGE)
    want = np.asarray(js.render_view(0, image_size=IMAGE))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # The overlay sits in the bottom-right corner.
    assert float(got[60:, 80:, 3].max()) > 0.9
    assert float(got[:20, :20].abs().max()) == 0.0
    (overlay,) = ts._overlay_cache.values()
    assert isinstance(overlay, torch.Tensor) and overlay.dim() == 3


def test_diagram_view_composites_jaxs_overlay_over_the_3d_frame():
    from correrender_tpu_torch.diagrams.raster import composite_overlay

    js, ts = scenes([("diagram", NODES["diagram"])], with_dvr=True)
    got = ts.render_view(0, image_size=IMAGE)
    plain = ts.render_view(0, image_size=IMAGE, show_diagram_overlays=False)
    js.render_view(0, image_size=IMAGE)
    (jax_raster,) = js._overlay_cache.values()
    want = composite_overlay(plain, np.asarray(jax_raster))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    h, w = jax_raster.shape[:2]
    outside = torch.ones(IMAGE[::-1], dtype=torch.bool)
    outside[IMAGE[1] - 8 - h:IMAGE[1] - 8, IMAGE[0] - 8 - w:IMAGE[0] - 8] = 0
    assert torch.equal(got[outside], plain[outside])
    assert float((got - plain).abs()[~outside].max()) > 0.3


def test_scene_overlays_at_every_anchor_match_jax():
    nodes = [("correlation_matrix", {}), ("scatter_plot", {}),
             ("diagram", {"downsample": 8, "overlay_frac": 0.3,
                          "overlay_opacity": 0.7}),
             ("time_series_correlation", {"overlay_anchor": "center"})]
    js, ts = scenes(nodes)
    got = ts.render_view(0, image_size=(200, 150))
    want = np.asarray(js.render_view(0, image_size=(200, 150)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert len(ts._overlay_cache) == 4


def test_overlays_are_cached_and_keyed_as_jax():
    js, ts = scenes([("correlation_matrix", {})])
    first = ts.render_view(0, image_size=IMAGE)
    again = ts.render_view(0, image_size=IMAGE)
    assert torch.equal(first, again) and len(ts._overlay_cache) == 1
    ts.render_view(0, image_size=(320, 240))
    assert len(ts._overlay_cache) == 2
    js.render_view(0, image_size=IMAGE)
    assert list(ts._overlay_cache)[0] == list(js._overlay_cache)[0]
    ts.renderers[-1]["overlay"] = False
    np.testing.assert_array_equal(
        ts.render_view(0, image_size=IMAGE).numpy(),
        ts.render_view(0, image_size=IMAGE,
                       show_diagram_overlays=False).numpy())


def test_failing_diagram_drops_its_overlay_with_a_warning(caplog):
    # A time-series node on a single-timestep volume has no source: the
    # JAX Scene logs and drops the overlay, and so does the port.
    rng = np.random.default_rng(0)
    data = rng.random((2, 1, 8, 16, 16)).astype(np.float32)
    jvd, tvd = volumes({"a": data})
    js, ts = JaxScene(jvd), Scene(tvd)
    for sc in (js, ts):
        sc.renderers.append({"type": "time_series_correlation", "view": 0})
        sc.renderers.append({"type": "correlation_matrix", "view": 0})
    with caplog.at_level(logging.WARNING):
        got = ts.render_view(0, image_size=IMAGE)
    assert "diagram overlay time_series_correlation skipped" in caplog.text
    assert list(ts._overlay_cache.values())[0] is False
    assert isinstance(list(ts._overlay_cache.values())[1], torch.Tensor)
    want = np.asarray(js.render_view(0, image_size=IMAGE))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_render_dock_matches_jax():
    from correrender_tpu.render import Camera as JaxCamera
    from correrender_tpu_torch.render.camera import Camera

    js, ts = scenes([("correlation_matrix", {})])
    js.views.append(JaxCamera(position=(0.3, 0.2, 0.9)))
    ts.views.append(Camera(position=(0.3, 0.2, 0.9)))
    for sc in (js, ts):
        sc.renderers.append({"type": "scatter_plot", "view": 1,
                             "field": "a", "field_b": "b"})
    for layout in ([[0, 1]], [[0], [1]], [[1, 0], []]):
        js.dock_layout = ts.dock_layout = layout
        got = ts.render_dock(image_size=(240, 180))
        want = np.asarray(js.render_dock(image_size=(240, 180)))
        assert got.shape == (180, 240, 4)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # A tile is the view's own frame at the tile's size.
    ts.dock_layout = [[0, 1]]
    np.testing.assert_array_equal(
        ts.render_dock(image_size=(240, 180))[:, 120:].numpy(),
        ts.render_view(1, image_size=(120, 180)).numpy())
