"""PyTorch port (``correrender_tpu_torch``) vs the JAX package: the utils
(histogram, profiling, app settings, logfile, path watch, LPIPS), the
``jax.random.split`` draw and the isosurface mesh.

The same seeded numpy inputs go through both packages. Bars: histogram
counts, min/max, the split keys, LPIPS-R's weights and the mesh's
vertices and triangles equal to the bit; LPIPS distances within 1e-5
relative of JAX's and 1e-4 of the checked-in torch goldens
(``tests/goldens/lpips_golden.json``).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from correrender_tpu.render import mesh as jax_mesh
from correrender_tpu.utils import app_settings as jax_settings
from correrender_tpu.utils import fixtures as jfixtures
from correrender_tpu.utils import histogram as jax_hist
from correrender_tpu.utils import logfile as jax_logfile
from correrender_tpu.utils import lpips_alex as jax_lpips
from correrender_tpu.utils import metrics as jax_metrics
from correrender_tpu.utils import pathwatch as jax_pathwatch

from correrender_tpu_torch import native
from correrender_tpu_torch.ops import noise
from correrender_tpu_torch.ops.precision import f32_conv
from correrender_tpu_torch.render import mesh
from correrender_tpu_torch.utils import (
    app_settings,
    fixtures,
    histogram,
    logfile,
    lpips_alex,
    metrics,
    pathwatch,
    profiling,
)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _field(seed=0, shape=(9, 10, 11), inf=True):
    """Normal values with NaN (and ±inf) sprinkled in."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape).astype(np.float32)
    flat = f.reshape(-1)
    idx = rng.choice(flat.size, 12, replace=False)
    flat[idx[:6]] = np.nan
    if inf:  # an infinite range: JAX's bin positions are NaN, bin 0
        flat[idx[6:9]] = np.inf
        flat[idx[9:]] = -np.inf
    return f


# -- histogram ---------------------------------------------------------------

@pytest.mark.parametrize("num_bins", [7, 256])
@pytest.mark.parametrize("bounds", [None, (-1.5, 2.5), (0.1, 0.7)])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("inf", [False, True])
def test_histogram_equals_jax(num_bins, bounds, normalize, inf):
    f = _field(inf=inf)
    counts, (lo, hi) = histogram.histogram(t(f), num_bins, bounds, normalize)
    want, (wlo, whi) = jax_hist.histogram(jnp.asarray(f), num_bins, bounds,
                                          normalize)
    want = np.asarray(want)
    if normalize:
        assert counts.dtype == torch.float32
        np.testing.assert_array_equal(counts.numpy(), want)
    else:  # exact int64 counts; JAX's float32 ones count exactly here
        assert counts.dtype == torch.int64
        np.testing.assert_array_equal(counts.numpy(), want.astype(np.int64))
    assert float(lo) == float(wlo) and float(hi) == float(whi)


def test_histogram_counts_past_2_24_in_one_bin():
    """Departure by design: JAX adds float32 ones, which stop counting at
    2^24 in one bin; the port's int64 counts are exact."""
    n = (1 << 24) + 3
    f = np.zeros(n, np.float32)
    counts, _ = histogram.histogram(t(f), 4, bounds=(0.0, 1.0),
                                    normalize=False)
    assert int(counts[0]) == n and int(counts[1:].sum()) == 0
    want, _ = jax_hist.histogram(jnp.asarray(f), 4, bounds=(0.0, 1.0),
                                 normalize=False)
    assert float(want[0]) < n


def test_min_max_equal_jax():
    f = _field(3)
    got = histogram.min_max(t(f))
    want = jax_hist.min_max(jnp.asarray(f))
    assert [float(v) for v in got] == [float(v) for v in want]
    finite = np.where(np.isfinite(f), f, 0.0)
    got = histogram.divergent_min_max(t(finite))
    want = jax_hist.divergent_min_max(jnp.asarray(finite))
    assert [float(v) for v in got] == [float(v) for v in want]
    nans = np.full((3, 4), np.nan, np.float32)
    assert all(np.isnan(float(v)) for v in histogram.min_max(t(nans)))
    assert all(np.isnan(float(v)) for v in jax_hist.min_max(
        jnp.asarray(nans)))


# -- profiling ---------------------------------------------------------------

def test_sync_returns_its_argument_and_trace_writes_chrome_json(tmp_path):
    x = {"a": [torch.ones(3)], "b": None}
    assert profiling.sync(x) is x
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        with profiling.zone("inside"):
            torch.ones(64).sum()
    doc = json.load(open(os.path.join(log_dir, "trace.json")))
    assert any(e.get("name") == "inside" for e in doc["traceEvents"])


# -- app settings, logfile, path watch ---------------------------------------

def test_settings_are_shared_with_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CORRERENDER_CONFIG_DIR", str(tmp_path))
    assert app_settings.config_directory() == \
        jax_settings.config_directory() == str(tmp_path)
    s = app_settings.AppSettings()
    assert s.path == jax_settings.AppSettings().path
    s.set("window-width", 1920)
    assert s.setdefault("window-vSync", True) is True
    s.save()
    j = jax_settings.AppSettings()
    assert j.as_dict() == s.as_dict()
    j.set("window-height", 1080)
    j.save()
    s.load()
    assert s.get("window-height") == 1080 and "window-width" in s
    (tmp_path / "settings.json").write_text("{not json")
    assert app_settings.AppSettings().as_dict() == {}


def test_logfile_writes_jaxs_format(tmp_path, capsys):
    lines = {}
    for name, mod in (("port", logfile), ("jax", jax_logfile)):
        log = mod.Logfile(str(tmp_path / f"{name}.html"))
        log.write("plain <b>")
        log.write_info("info")
        log.write_warning("careful")
        log.write_error("soft")
        with pytest.raises(ValueError, match="fatal"):
            log.throw_error("fatal", ValueError)
        text = open(log.path).read()
        lines[name] = re.sub(r"\[\d\d:\d\d:\d\d\]", "[t]", text)
    assert lines["port"] == lines["jax"]
    assert "&lt;b&gt;" in lines["port"]
    err = capsys.readouterr().err
    assert err.count("[warning] careful") == 2
    assert err.count("[error] fatal") == 2


def test_catalog_watch_reloads_like_jax(tmp_path):
    path = tmp_path / "datasets.json"
    watch = pathwatch.CatalogWatch(str(path))
    jwatch = jax_pathwatch.CatalogWatch(str(path))
    assert watch.poll() is None and not watch.update()
    path.write_text(json.dumps({"datasets": [
        {"name": "a", "filename": "a.nc"}, {"name": "b", "filename": "b.nc"}]}))
    got, want = watch.poll(), jwatch.poll()
    assert [e.name for e in got] == [e.name for e in want] == ["a", "b"]
    assert watch.poll() is None
    calls = []
    path.unlink()
    assert watch.update(lambda: calls.append(1)) and calls == [1]
    assert pathwatch.PathWatch().update() is False


# -- jax.random.split ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 617406168, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 2, 5, 13])
def test_split_like_jax_is_jaxs_to_the_bit(seed, n):
    want = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(seed), n)))
    got = np.asarray(noise.split_like_jax(seed, n), np.uint32)
    np.testing.assert_array_equal(got, want)
    # A split key splits again as JAX's does.
    want2 = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.wrap_key_data(jnp.asarray(want[-1])), 3)))
    got2 = np.asarray(noise.split_like_jax(tuple(got[-1]), 3), np.uint32)
    np.testing.assert_array_equal(got2, want2)


# -- LPIPS ---------------------------------------------------------------------

def test_lpips_random_weights_are_jaxs_to_the_bit():
    got = metrics._lpips_random_params()
    want = jax_metrics._lpips_random_params()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g.view(np.uint32),
                                      np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("shape", [(32, 32, 3), (33, 47, 3), (18, 25, 4),
                                   (17, 20), (21, 9, 1)])
def test_lpips_random_matches_jax(shape):
    """Odd sizes take XLA's asymmetric SAME padding of stride 2."""
    rng = np.random.default_rng(sum(shape))
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(
        np.float32)
    want = jax_metrics.lpips_random(a, b)
    got = metrics.lpips_random(a, b, device="cpu")
    assert abs(got - want) <= 1e-5 * want
    assert metrics.lpips_random(a, a, device="cpu") == 0.0


def test_same_padding_is_xlas():
    for n in range(1, 12):
        x = torch.zeros(1, 1, n, n + 1)
        p = metrics._same_pad_stride2(x)
        for size, got in ((n, p.shape[2]), (n + 1, p.shape[3])):
            out = -(-size // 2)
            assert (got - 3) // 2 + 1 == out  # stride-2 output = ceil(n/2)
            assert got - size == max((out - 1) * 2 + 3 - size, 0)


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(GOLDENS, "lpips_golden.json")) as f:
        return json.load(f)


def _golden_inputs(golden):
    rng = np.random.default_rng(golden["seed_inputs"])
    shape = tuple(golden["shape"])
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(
        np.float32)
    return {"near": (a, b), "invert": (a, (1.0 - a).astype(np.float32)),
            "gray_vs_a": (np.full(shape, 0.5, np.float32), a)}


def test_lpips_alex_matches_golden_and_jax(golden):
    params_np = lpips_alex.synthetic_lpips_params(golden["seed_weights"])
    jparams = jax_lpips.synthetic_lpips_params(golden["seed_weights"])
    for k in jparams:
        np.testing.assert_array_equal(params_np[k], jparams[k])
    params = lpips_alex.params_to_device(params_np, "cpu")
    for name, (x, y) in _golden_inputs(golden).items():
        case = golden["cases"][name]
        got = lpips_alex.lpips_alex(x, y, params)
        want = jax_lpips.lpips_alex(x, y, jparams)
        assert got == pytest.approx(case["distance"], abs=1e-4), name
        assert abs(got - want) <= 1e-5 * want, name
        xt = torch.from_numpy(np.moveaxis(x, -1, 0)[None] * 2.0 - 1.0)
        taps = lpips_alex.alexnet_features(xt, params)
        for i, tap_mean in enumerate(case["tap_means_a"]):
            assert float(taps[i].mean()) == pytest.approx(tap_mean,
                                                          abs=1e-4)
    a = _golden_inputs(golden)["near"][0]
    assert abs(lpips_alex.lpips_alex(a, a, params)) < 1e-7


def test_weights_convert_and_load(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("CORRERENDER_LPIPS_WEIGHTS", raising=False)
    out = str(tmp_path / "lpips_alex.npz")
    lpips_alex.convert_lpips_weights(
        os.path.join(GOLDENS, "lpips_fixture_alexnet.pth"),
        os.path.join(GOLDENS, "lpips_fixture_heads.pth"), out)
    jout = str(tmp_path / "jax.npz")
    jax_lpips.convert_lpips_weights(
        os.path.join(GOLDENS, "lpips_fixture_alexnet.pth"),
        os.path.join(GOLDENS, "lpips_fixture_heads.pth"), jout)
    params = lpips_alex.load_lpips_weights(out, device="cpu")
    assert lpips_alex.load_lpips_weights(out, device=torch.device("cpu")) \
        is params
    with np.load(jout) as want:
        assert set(want.files) == set(params)
        for k in want.files:
            np.testing.assert_array_equal(params[k].numpy(), want[k])
    assert lpips_alex.load_lpips_weights(str(tmp_path / "none.npz"),
                                         device="cpu") is None


def test_metrics_resolve_weights_then_lpips_r(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("CORRERENDER_LPIPS_WEIGHTS", raising=False)
    rng = np.random.default_rng(2)
    a = rng.random((64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    assert metrics.lpips(a, b, device="cpu") == metrics.lpips_random(
        a, b, device="cpu")
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **lpips_alex.synthetic_lpips_params(0))
    monkeypatch.setenv("CORRERENDER_LPIPS_WEIGHTS", npz)
    want = jax_metrics.lpips(a, b)
    got = metrics.lpips(a, b, device="cpu")
    assert abs(got - want) <= 1e-5 * want
    assert abs(metrics.lpips(a, a, device="cpu")) < 1e-6


def test_compare_images_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("CORRERENDER_LPIPS_WEIGHTS", raising=False)
    rng = np.random.default_rng(4)
    a = rng.random((40, 36, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    got = metrics.compare_images(a, b, device="cpu")
    want = jax_metrics.compare_images(a, b)
    assert got.keys() == want.keys()
    for k in ("mse", "psnr", "ssim"):
        assert got[k] == want[k], k
    assert abs(got["lpips"] - want["lpips"]) <= 1e-5 * want["lpips"]


def test_f32_conv_restores_the_callers_setting():
    saved = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            with f32_conv():
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# -- mesh ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def volume():
    return jfixtures.synth_box_ensemble(xs=12, ys=12, zs=6, members=15)[0]


@pytest.mark.parametrize("gamma", [0.0, 0.3])
@pytest.mark.parametrize("dedupe", [True, False])
def test_mesh_equals_jax_to_the_bit(volume, gamma, dedupe):
    want = jax_mesh.extract_isosurface(volume, 0.5, dedupe=dedupe,
                                       snap_gamma=gamma)
    got = mesh.extract_isosurface(volume, 0.5, dedupe=dedupe,
                                  snap_gamma=gamma)
    assert len(got[1]) > 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(mesh.vertex_normals(*got),
                                  jax_mesh.vertex_normals(*want))


def test_unique_rows_is_numpys():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 4, size=(500, 3)).astype(np.float32) / 2
    want, want_inv = np.unique(rows, axis=0, return_inverse=True)
    got, got_inv = mesh._unique_rows(rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_inv, want_inv.reshape(-1))


def test_mesh_of_a_tensor_with_nan_cells(volume):
    vol = volume.copy()
    vol[2:4, 5:8, 5:8] = np.nan
    want = jax_mesh.extract_isosurface(vol, 0.25)
    got = mesh.extract_isosurface(t(vol), 0.25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    empty = mesh.extract_isosurface(np.zeros((3, 3, 3), np.float32), 0.5)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_mesh_library_is_built_under_build():
    mesh.library()
    lib = native.library_path(mesh._SOURCE, mesh._BUILD_DIR)
    assert lib.exists() and lib.parent.name == "mesh"
    assert lib.parent.parent == native.BUILD_ROOT


def test_missing_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build_library(mesh._SOURCE, tmp_path / "mesh",
                             "the isosurface extractor")


@pytest.mark.parametrize("seed, rho", [(0, 0.5), (1, 0.0), (7, 1.0),
                                       (3, 0.9)])
def test_multivariate_gaussian_pair_is_jaxs(seed, rho):
    got = fixtures.multivariate_gaussian_pair(40, 25, rho, seed=seed)
    want = jfixtures.multivariate_gaussian_pair(40, 25, rho, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == (40, 25)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rho", [-0.1, 1.5])
def test_multivariate_gaussian_pair_refuses_rho_outside_0_1(rho):
    with pytest.raises(ValueError, match="rho"):
        fixtures.multivariate_gaussian_pair(4, 5, rho)
