"""PyTorch port (correrender_tpu_torch) vs the JAX package: the derived
field calculators and their ops (``ops/dkl.py``, ``ops/similarity.py``,
``calculators/{ensemble,binop,noise,set_predicate,residual_color,
velocity,dkl_calculator}.py``), ``load_volume``'s velocity calculators,
settings round trips and the reference app's state files.

Each port calculator is built from the JAX calculator's
``get_settings()`` through ``calculator_from_settings`` and runs on the
same seeded numpy inputs, on the CPU. Every tolerance stands beside its
assert with where it comes from; where XLA and torch round differently,
the bar comes from a float64 evaluation of the same function.
"""

import copy
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma

from correrender_tpu.app import state_ref as jax_state_ref
from correrender_tpu.app.state import Scene as JaxScene
from correrender_tpu.calculators.base import (
    calculator_from_settings as jax_from_settings,
)
from correrender_tpu.calculators.noise import (
    gaussian_blur_3d as jax_blur,
    gaussian_kernel_1d as jax_kernel,
)
from correrender_tpu.core.fields import GridMetadata as JaxGrid
from correrender_tpu.core.fields import VolumeData as JaxVolumeData
from correrender_tpu.io.base import load_volume as jax_load_volume
from correrender_tpu.ops import dkl as jax_dkl
from correrender_tpu.ops.similarity import (
    field_similarity as jax_field_similarity,
    volume_field_similarity as jax_volume_similarity,
)

from correrender_tpu_torch.app import state_ref
from correrender_tpu_torch.app.baseline_configs import write_zarr_array
from correrender_tpu_torch.app.state import Scene
from correrender_tpu_torch.calculators import base as calc_base
from correrender_tpu_torch.calculators.base import calculator_from_settings
from correrender_tpu_torch.calculators.noise import (
    gaussian_blur_3d,
    gaussian_kernel_1d,
)
from correrender_tpu_torch.calculators.binop import BINARY_OPERATOR_NAMES
from correrender_tpu_torch.calculators.set_predicate import COMPARISON_GLYPHS
from correrender_tpu_torch.core.fields import GridMetadata, VolumeData
from correrender_tpu_torch.interop import stack_from_numpy
from correrender_tpu_torch.io import load_volume
from correrender_tpu_torch.ops import dkl
from correrender_tpu_torch.ops.similarity import (
    field_similarity,
    volume_field_similarity,
)

EPS32 = 2.0 ** -24

A7_TYPES = ("velocity", "vector_magnitude", "vorticity", "helicity",
            "binary_operator", "noise_reduction", "ensemble_mean",
            "ensemble_spread", "set_predicate", "residual_color",
            "dkl_calculator")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def ensemble(seed=0, shape=(12, 1, 6, 7, 9), nan_members=0):
    """(E, T, Z, Y, X) float32 around a smooth shared signal; with
    ``nan_members``, that many members hold NaN at a few voxels."""
    rng = np.random.default_rng(seed)
    es, ts, zs, ys, xs = shape
    z, y, x = np.meshgrid(*(np.linspace(-1, 1, n) for n in (zs, ys, xs)),
                          indexing="ij")
    base = np.sin(3 * x) * np.cos(2 * y) + z
    data = np.stack([[base * (1 + 0.3 * rng.normal()) + 0.4 * rng.normal(
        size=base.shape) for _ in range(ts)] for _ in range(es)]).astype(
            np.float32)
    for e in range(nan_members):
        flat = data[e].reshape(-1)
        flat[rng.choice(flat.size, 5, replace=False)] = np.nan
    return data


def volumes(fields: dict, bf16=False, spacing=(1.0, 1.0, 1.0)):
    """A JAX and a port VolumeData (CPU) serving the same arrays."""
    first = next(iter(fields.values()))
    es, ts, zs, ys, xs = first.shape
    grid = dict(xs=xs, ys=ys, zs=zs, ts=ts, es=es, dx=spacing[0],
                dy=spacing[1], dz=spacing[2])
    jvd = JaxVolumeData(JaxGrid(**grid),
                        member_stack_dtype=jnp.bfloat16 if bf16 else None)
    tvd = VolumeData(GridMetadata(**grid), device="cpu",
                     member_stack_dtype=torch.bfloat16 if bf16 else None)
    for name, data in fields.items():
        jvd.add_field(name, lambda t, e, d=data: d[e, t])
        tvd.add_field(name, lambda t, e, d=data: d[e, t])
    return jvd, tvd


def jax_calc(type_id, **kw):
    return jax_from_settings(type_id, {}) if not kw else type(
        jax_from_settings(type_id, {}))(**kw)


def pair(type_id, fields, t=0, e=0, bf16=False, spacing=(1, 1, 1), **kw):
    """The same calculator in both packages (the port's built from the
    JAX calculator's settings) over the same fields; both outputs as
    numpy, and the two calculators."""
    jvd, tvd = volumes(fields, bf16=bf16, spacing=spacing)
    jc = jax_calc(type_id, **kw)
    tc = calculator_from_settings(type_id, jc.get_settings())
    assert tc.get_settings() == jc.get_settings()
    assert tc.output_name == jc.output_name
    jvd.add_calculator(jc)
    tvd.add_calculator(tc)
    return (np.asarray(jvd.get_field(jc.output_name, t, e)),
            tvd.get_field(tc.output_name, t, e).numpy(), jc, tc)


def assert_nan_equal(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


# -- ops/dkl.py -------------------------------------------------------------

def normalized64(v):
    x = v.astype(np.float64)
    m = x.mean(-1, keepdims=True)
    return (x - m) / np.sqrt(((m - x) ** 2).mean(-1, keepdims=True))


@pytest.mark.parametrize("num_bins", [80, 7])
@pytest.mark.parametrize("seed,voxels,n", [(0, 3000, 37), (1, 500, 100),
                                          (2, 800, 5)])
def test_dkl_binned_matches_jax(seed, voxels, n, num_bins):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(voxels, n)) * 3 + 1).astype(np.float32)
    v[::50, 1] = np.nan  # NaN members give NaN in both
    want = np.asarray(jax_dkl.dkl_binned(jnp.asarray(v), num_bins=num_bins))
    got = dkl.dkl_binned(stack_from_numpy(v), num_bins).numpy()
    assert_nan_equal(got, want)
    assert np.isnan(got[::50]).all()
    # The edge rule: a sample's bin is (vn − vmin)·b/(vmax − vmin)
    # truncated, and XLA and torch may round the mean and the scale one
    # ulp apart. A voxel may move a sample by one bin only where some
    # sample lies within 8 float32 ulps of an edge in a float64
    # evaluation; every other voxel agrees within 1e-5 (the sums of p log
    # p over 80 bins in float32 differ by a few e-7, measured 3.6e-7).
    vn = normalized64(v)
    lo = vn.min(-1, keepdims=True) - 0.01
    hi = vn.max(-1, keepdims=True) + 0.01
    pos = (vn - lo) * num_bins / (hi - lo)
    near_edge = (np.abs(pos - np.round(pos))
                 < 8 * EPS32 * np.maximum(pos, 1)).any(-1)
    diff = np.abs(got - want)
    far = ~near_edge & ~np.isnan(want)
    assert diff[far].max() <= 1e-5
    assert (diff > 1e-5).sum() <= near_edge.sum()


def kth_distance_by_rows(vn, k):
    """JAX's formulation: all pairwise |v_i − v_j|, self excluded, the
    k-th smallest per point."""
    n = vn.shape[-1]
    d = np.abs(vn[..., :, None] - vn[..., None, :])
    d[..., np.arange(n), np.arange(n)] = np.inf
    return np.sort(d, -1)[..., k - 1]


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_kth_neighbour_distance_equals_the_full_rows(k):
    # Rows with repeated values (and a row of one value): the sorted
    # window gives the same float as the k-th of the full sorted row.
    rng = np.random.default_rng(k)
    vn = np.round(rng.normal(size=(400, 23)) * 2).astype(np.float32) / 4
    vn[0] = 0.5
    s = np.sort(vn, -1)
    want = kth_distance_by_rows(s, k)
    got = dkl.kth_neighbour_distance(torch.from_numpy(s), k).numpy()
    np.testing.assert_array_equal(got, want)


def knn_condition(v, k):
    """Rounding of the normalized samples propagated through log d_k:
    mean over points of max|vn| / d_k, in float32 ulps."""
    vn = normalized64(v)
    dk = kth_distance_by_rows(vn, k)
    return (np.abs(vn).max(-1, keepdims=True) / dk).mean(-1) * EPS32


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("n", [37, 100])
def test_dkl_knn_matches_jax(k, n):
    rng = np.random.default_rng(n + k)
    v = (rng.normal(size=(1500, n)) * 3 + 1).astype(np.float32)
    want = np.asarray(jax_dkl.dkl_knn(jnp.asarray(v), k=k))
    got = dkl.dkl_knn(stack_from_numpy(v), k).numpy()
    # Bar: 2e-6 for the float32 means, plus 8 ulps of the largest |vn|
    # carried through log d_k (near-tied neighbours make k = 1 ill
    # conditioned: both packages are up to 1.1e-2 from a float64
    # evaluation there, and differ by at most 3× this term, measured).
    # A float32 tie (d_k = 0) gives NaN in both.
    assert_nan_equal(got, want)
    ok = ~np.isnan(want)
    bar = 2e-6 + 8 * knn_condition(v[ok], k)
    assert (np.abs(got[ok] - want[ok]) <= bar).all()
    # The float64 form of the estimator (DKL.cpp:133-169).
    vn = normalized64(v[ok])
    h = (np.log(kth_distance_by_rows(vn, k)).mean(-1) + digamma(n)
         - digamma(k) + math.log(2.0))
    ref = np.maximum(-h + 0.5 * math.log(2 * math.pi)
                     + 0.5 * (vn * vn).mean(-1), 0.0)
    assert (np.abs(got[ok] - ref) <= bar).all()


@pytest.mark.parametrize("step", [0.5, 0.125])
def test_dkl_knn_ties_give_nan_where_jax_does(step):
    # Quantized members: exact ties make d_k = 0, log 0 = −inf and the
    # estimate NaN, in the same voxels as JAX's; elsewhere within the
    # bar above.
    rng = np.random.default_rng(3)
    v = np.round(rng.normal(size=(2000, 37)) / step) * step
    v = v.astype(np.float32)
    want = np.asarray(jax_dkl.dkl_knn(jnp.asarray(v), k=3))
    got = dkl.dkl_knn(stack_from_numpy(v), 3).numpy()
    assert np.isnan(want).sum() > 100
    assert_nan_equal(got, want)
    ok = ~np.isnan(want)
    bar = 2e-6 + 8 * knn_condition(v[ok], 3)
    assert (np.abs(got[ok] - want[ok]) <= bar).all()


def test_dkl_knn_nan_member_and_clamp():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(40, 30)).astype(np.float32)
    v[3, 7] = np.nan
    v[5] = np.linspace(-1, 1, 30)  # uniform: the clamp at 0 may bite
    want = np.asarray(jax_dkl.dkl_knn(jnp.asarray(v), k=3))
    got = dkl.dkl_knn(stack_from_numpy(v), 3).numpy()
    assert np.isnan(got[3]) and np.isnan(want[3])
    assert (got[~np.isnan(got)] >= 0).all()
    assert_nan_equal(got, want)


# -- ops/similarity.py ------------------------------------------------------

#: Per measure: the bar of the measure's own port tests against JAX on
#: one long pair (Pearson's f32 sums over 2-3 k samples; the rank
#: measures' exact counts; MI as test_torch_port_measures states).
SIMILARITY_BARS = {
    "pearson": 2e-6, "spearman": 2e-6, "kendall": 1e-6, "mi_binned": 2e-5,
    "binned_mi_correlation_coefficient": 2e-5, "mi_kraskov": 2e-4,
    "kmi_correlation_coefficient": 2e-4,
}


@pytest.mark.parametrize("max_samples", [200_000, 900])
@pytest.mark.parametrize("measure", sorted(SIMILARITY_BARS))
def test_field_similarity_matches_jax(measure, max_samples):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(10, 12, 14)).astype(np.float32)
    b = (0.6 * a + 0.5 * rng.normal(size=a.shape)).astype(np.float32)
    a.reshape(-1)[::37] = np.nan
    b.reshape(-1)[::53] = np.inf
    kw = dict(max_samples=max_samples, seed=7)
    want = jax_field_similarity(a, b, measure, **kw)
    got = field_similarity(torch.from_numpy(a), torch.from_numpy(b),
                           measure, **kw)
    assert isinstance(got, float)
    assert got == pytest.approx(want, abs=SIMILARITY_BARS[measure])


@pytest.mark.parametrize("measure,cap", [("kendall", 46340),
                                         ("mi_kraskov", 16384),
                                         ("pearson", 200_000)])
def test_field_similarity_caps_draw_jax_subsample(measure, cap,
                                                   monkeypatch):
    # Kendall at the int32 pair counts' exact limit, KSG at its working
    # set's: the measure sees numpy's default_rng(seed).choice of the
    # finite pairs, the JAX package's draw (correlate itself is the
    # measure tests' subject, so it is replaced by a probe here).
    from correrender_tpu_torch.ops import similarity

    rng = np.random.default_rng(6)
    a = rng.normal(size=250_000).astype(np.float32)
    b = (a + rng.normal(size=a.shape)).astype(np.float32)
    a[::1000] = np.nan
    seen = {}

    def probe(x, y, m, **kw):
        seen.update(x=x.numpy(), y=y.numpy())
        return torch.tensor(0.0)

    monkeypatch.setattr(similarity, "correlate", probe)
    field_similarity(torch.from_numpy(a), torch.from_numpy(b), measure,
                     seed=3)
    ok = np.isfinite(a) & np.isfinite(b)
    idx = np.random.default_rng(3).choice(ok.sum(), cap, replace=False)
    np.testing.assert_array_equal(seen["x"], a[ok][idx])
    np.testing.assert_array_equal(seen["y"], b[ok][idx])
    with pytest.raises(ValueError, match="shape mismatch"):
        field_similarity(torch.from_numpy(a), torch.from_numpy(b[:10]))
    # Arrays are refused rather than run on the CPU unasked.
    with pytest.raises(TypeError, match="takes tensors"):
        field_similarity(a, b)


@pytest.mark.parametrize("all_members", [False, True])
def test_volume_field_similarity_matches_jax(all_members):
    data = {"a": ensemble(8, shape=(3, 1, 5, 6, 7)),
            "b": ensemble(9, shape=(3, 1, 5, 6, 7))}
    jvd, tvd = volumes(data)
    want = jax_volume_similarity(jvd, "a", "b", "spearman",
                                 all_members=all_members)
    got = volume_field_similarity(tvd, "a", "b", "spearman",
                                  all_members=all_members)
    assert got == pytest.approx(want, abs=2e-6)


# -- ensemble mean and spread -----------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("type_id", ["ensemble_mean", "ensemble_spread"])
def test_ensemble_calculators_match_jax(type_id, bf16):
    data = {"q": ensemble(10, shape=(9, 2, 6, 7, 9), nan_members=3)}
    want, got, _, _ = pair(type_id, data, t=1, field_name="q", bf16=bf16)
    assert got.shape == want.shape == (6, 7, 9)
    assert_nan_equal(got, want)
    # float32 sums over 9 members in another order (a bfloat16 stack is
    # upcast exactly first): a few ulps of values about 2.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ensemble_slabs_cover_the_stack(monkeypatch):
    # Slabs of 2 planes over 5 (a remainder of 1) give the same field.
    data = {"q": ensemble(11, shape=(6, 1, 5, 4, 3))}
    whole, _, _, _ = pair("ensemble_spread", data, field_name="q")
    monkeypatch.setattr(calc_base, "SLAB_BUDGET_BYTES", 2 * 4 * 6 * 4 * 3)
    _, got, _, _ = pair("ensemble_spread", data, field_name="q")
    np.testing.assert_allclose(got, whole, rtol=1e-6, atol=1e-6)


# -- binary operator --------------------------------------------------------

@pytest.mark.parametrize("operator", sorted(BINARY_OPERATOR_NAMES))
def test_binary_operator_matches_jax(operator):
    a = ensemble(12, nan_members=1)
    data = {"a": a, "b": ensemble(13)}
    want, got, jc, tc = pair("binary_operator", data, field_name_a="a",
                             field_name_b="b", operator=operator)
    assert tc.operator == BINARY_OPERATOR_NAMES[operator]
    assert_nan_equal(got, want)
    np.testing.assert_array_equal(got, want)  # one IEEE op a voxel


def test_binary_operator_rejects_an_unknown_operator():
    with pytest.raises(ValueError, match="unknown operator"):
        calculator_from_settings("binary_operator",
                                 {"operator_type": "Power"})


# -- noise reduction --------------------------------------------------------

@pytest.mark.parametrize("sigma", [-1.0, 0.0, 0.5, 1.0, 2.0, 3.3])
def test_gaussian_kernel_equals_jax(sigma):
    np.testing.assert_array_equal(gaussian_kernel_1d(sigma),
                                  jax_kernel(sigma))


@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 2.0])
def test_gaussian_blur_matches_jax(sigma):
    rng = np.random.default_rng(14)
    vol = rng.normal(size=(5, 9, 13)).astype(np.float32)
    want = np.asarray(jax_blur(jnp.asarray(vol), sigma))
    got = gaussian_blur_3d(torch.from_numpy(vol), sigma).numpy()
    # Float32 sums of 2r + 1 ≤ 13 taps per axis, three axes: XLA's
    # convolution and the shifted products round apart by a few ulps of
    # the unit-scale values (the kernel sums to 1).
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # Against float64 separable sums with the same float32 taps.
    ref = vol.astype(np.float64)
    taps = gaussian_kernel_1d(sigma).astype(np.float64)
    r = len(taps) // 2
    for axis in range(3):
        size = ref.shape[axis]
        idx = np.clip(np.arange(-r, size + r), 0, size - 1)
        padded = np.take(ref, idx, axis=axis)
        ref = sum(w * np.take(padded, np.arange(k, k + size), axis=axis)
                  for k, w in enumerate(taps))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("sigma", [0.0, 0.5, 2.0])
def test_noise_reduction_calculator_matches_jax(sigma):
    data = {"q": ensemble(15, shape=(3, 1, 8, 6, 7))}
    want, got, _, _ = pair("noise_reduction", data, e=2, field_name="q",
                           sigma=sigma)
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    if sigma == 0.0:
        np.testing.assert_array_equal(got, data["q"][2, 0])


# -- set predicate ----------------------------------------------------------

@pytest.mark.parametrize("aggregation", ["count", "fraction", "any", "all"])
@pytest.mark.parametrize("comparison", ["greater", "greater_equal", "less",
                                        "less_equal", "equal", "not_equal",
                                        "between"])
def test_set_predicate_matches_jax(comparison, aggregation):
    # Quantized members, so equal and the closed bounds are exercised.
    data = {"q": np.round(ensemble(16, nan_members=2) * 4) / 4}
    want, got, _, _ = pair("set_predicate", data, field_name="q",
                           comparison=comparison, aggregation=aggregation,
                           threshold=0.25, threshold_upper=1.0)
    # Counts of booleans are exact; the fraction is the same integer
    # count over n, which XLA takes as a product with 1/n: one ulp.
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)


@pytest.mark.parametrize("lo,hi", [(3, 3), (2, 8), (0, 12)])
@pytest.mark.parametrize("glyph", sorted(COMPARISON_GLYPHS))
def test_set_predicate_count_range_matches_jax(glyph, lo, hi):
    data = {"q": np.round(ensemble(17) * 4) / 4}
    settings = {"scalar_field_name": "q", "comparison_operator_type": glyph,
                "comparison_value": "0.5", "count_lower": lo,
                "count_upper": hi}
    jvd, tvd = volumes(data)
    jc = jax_from_settings("set_predicate", settings)
    tc = calculator_from_settings("set_predicate", settings)
    assert tc.aggregation == "count_range"
    assert tc.get_settings() == jc.get_settings()
    jvd.add_calculator(jc)
    tvd.add_calculator(tc)
    want = np.asarray(jvd.get_field(jc.output_name))
    got = tvd.get_field(tc.output_name).numpy()
    # (count − lo)/(hi − lo) of integer counts: JAX divides by a host
    # float, the port by a tensor; equal within one ulp.
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    assert got.min() >= 0 and got.max() <= 1


# -- residual colour --------------------------------------------------------

@pytest.mark.parametrize("colormap", ["coolwarm", "Viridis"])
def test_residual_color_matches_jax(colormap):
    data = {"a": ensemble(18, nan_members=1), "b": ensemble(19)}
    want, got, _, tc = pair("residual_color", data, field_name_a="a",
                            field_name_b="b", colormap=colormap)
    assert tc.output_type.value == "color"
    assert got.shape == want.shape == data["a"].shape[2:] + (4,)
    # A LUT lerp of (a − b)/max|a − b| in float32: the scaled value may
    # differ by an ulp (JAX's XLA contracts), moving the lerp by an ulp
    # times the LUT's slope (≤ 256 over the 256 entries).
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


# -- velocity ---------------------------------------------------------------

def flow(shape=(2, 1, 7, 8, 9), seed=20):
    """u, v, w of a smooth analytic flow with a phase per member."""
    es, ts, zs, ys, xs = shape
    z, y, x = np.meshgrid(*(np.linspace(0, 2 * np.pi, n) for n in
                            (zs, ys, xs)), indexing="ij")
    phase = np.random.default_rng(seed).uniform(0, 1, size=es)
    u = np.stack([[np.sin(y + p) * np.cos(z)] * ts for p in phase])
    v = np.stack([[np.sin(z + p) * np.cos(x)] * ts for p in phase])
    w = np.stack([[np.sin(x + 2 * p) * np.cos(y)] * ts for p in phase])
    return {k: a.astype(np.float32) for k, a in zip("uvw", (u, v, w))}


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.5, 2.0, 1.5)])
@pytest.mark.parametrize("type_id", ["velocity", "vector_magnitude",
                                     "vorticity", "helicity"])
def test_velocity_calculators_match_jax(type_id, spacing):
    data = flow()
    want, got, _, _ = pair(type_id, data, e=1, spacing=spacing)
    assert got.shape == want.shape
    # XLA contracts u·cx + v·cy + w·cz and the differences into FMAs, the
    # port rounds each operation: a few ulps of the largest term (|u|,
    # |curl| ≤ 2/spacing), measured 4.8e-7 against a 1e-6 bar.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_central_difference_against_float64():
    from correrender_tpu_torch.calculators.velocity import _central_diff

    rng = np.random.default_rng(21)
    f = rng.normal(size=(4, 5, 6)).astype(np.float32)
    for axis, h in ((0, 0.5), (1, 2.0), (2, 1.5)):
        got = _central_diff(torch.from_numpy(f), axis, h).numpy()
        g = np.moveaxis(f.astype(np.float64), axis, 0)
        ref = np.empty_like(g)
        ref[1:-1] = (g[2:] - g[:-2]) / (2 * h)
        ref[0] = (g[1] - g[0]) / h
        ref[-1] = (g[-1] - g[-2]) / h
        np.testing.assert_allclose(got, np.moveaxis(ref, 0, axis),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("names", ["uvw", "UVW"])
def test_load_volume_registers_the_velocity_calculators(tmp_path, names):
    data = flow(shape=(2, 1, 5, 6, 7))
    store = tmp_path / "wind.zarr"
    for key, name in zip("uvw", names):
        write_zarr_array(str(store / name), data[key], (1, 1, 5, 6, 7))
    jvd = jax_load_volume(str(store))
    tvd = load_volume(str(store), device="cpu")
    assert tvd.field_names == jvd.field_names
    assert sorted(tvd.calculators) == ["Helicity", "Vector Magnitude",
                                       "Vorticity"]
    for name in ("Vector Magnitude", "Vorticity", "Helicity"):
        calc = tvd.calculators[name]
        assert (calc.u, calc.v, calc.w) == tuple(names)
        np.testing.assert_allclose(tvd.get_field(name, 0, 1).numpy(),
                                   np.asarray(jvd.get_field(name, 0, 1)),
                                   rtol=0, atol=1e-6)  # as above


# -- DKL calculator ---------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("estimator", ["binned", "knn"])
def test_dkl_calculator_matches_jax(estimator, bf16, monkeypatch):
    data = {"q": ensemble(22, shape=(30, 1, 7, 5, 6))}
    # Slabs of 3 planes over 7 (a remainder of 1); JAX's one slab.
    monkeypatch.setattr(calc_base, "SLAB_BUDGET_BYTES", 3 * 4 * 30 * 5 * 6)
    want, got, _, _ = pair("dkl_calculator", data, field_name="q",
                           estimator=estimator, bf16=bf16, num_bins=20)
    assert got.shape == (7, 5, 6)
    if estimator == "binned":
        stack = data["q"][:, 0]
        if bf16:
            stack = np.asarray(jnp.asarray(stack, jnp.bfloat16), np.float32)
        ref = np.asarray(jax_dkl.dkl_binned(jnp.asarray(
            np.moveaxis(stack, 0, -1).reshape(-1, 30)), num_bins=20))
        # The edge rule of test_dkl_binned_matches_jax on these series.
        assert (np.abs(got.reshape(-1) - ref) > 1e-5).sum() <= 2
    else:
        series = np.moveaxis(data["q"][:, 0], 0, -1).reshape(-1, 30)
        if bf16:
            series = np.asarray(jnp.asarray(series, jnp.bfloat16),
                                np.float32)
        bar = 2e-6 + 8 * knn_condition(series, 3)
        assert (np.abs(got.reshape(-1) - want.reshape(-1)) <= bar).all()


# -- settings, registry and the reference app's state files ----------------

SETTINGS = {
    "velocity": {"u_field": "U", "v_field": "V", "w_field": "W"},
    "vector_magnitude": {},
    "vorticity": {"u_field": "a"},
    "helicity": {},
    "binary_operator": {"operator_type": "Absolute Difference",
                        "scalar_field_name_0": "a",
                        "scalar_field_name_1": "b"},
    "noise_reduction": {"scalar_field_name": "a", "standard_deviation": 0.0},
    "ensemble_mean": {"scalar_field_name": "a"},
    "ensemble_spread": {"scalar_field_name": "b"},
    "set_predicate": {"scalar_field_name": "a", "comparison": "between",
                      "aggregation": "any", "threshold": -1.0,
                      "threshold_upper": 2.0},
    "residual_color": {"scalar_field_name_0": "a",
                       "scalar_field_name_1": "b", "colormap": "Viridis"},
    "dkl_calculator": {"scalar_field_name": "a", "estimator": "knn",
                       "mi_bins": 40, "knn_neighbors": 5},
}


@pytest.mark.parametrize("type_id", A7_TYPES)
def test_settings_round_trip_like_jax(type_id):
    settings = dict(SETTINGS[type_id], continuous_recompute=True)
    jc = jax_from_settings(type_id, dict(settings))
    tc = calculator_from_settings(type_id, dict(settings))
    assert tc.get_settings() == jc.get_settings()
    assert tc.output_name == jc.output_name
    assert tc.input_fields() == jc.input_fields()
    assert tc.continuous_recompute
    again = calculator_from_settings(type_id, tc.get_settings())
    assert again.get_settings() == tc.get_settings()


#: Each A.7 type as a reference state node (the reference's own keys:
#: field indices, GUI names, glyphs), with its unmapped keys.
REFERENCE_NODES = {
    "binary_operator": {"binary_operator_type": "Product",
                        "scalar_field_idx_0": "1", "scalar_field_idx_1": "0",
                        "device": "Vulkan"},
    "noise_reduction": {"scalar_field_idx": "1", "sigma": "1.5",
                        "kernel_size": "5",
                        "noise_reduction_type": "Median"},
    "ensemble_mean": {"scalar_field_idx": "0"},
    "ensemble_spread": {"scalar_field_idx": "1", "an_unknown_key": "3"},
    "set_predicate": {"scalar_field_idx": "0",
                      "comparison_operator_type": ">=",
                      "comparison_value": "0.5", "count_lower": "2",
                      "count_upper": "6", "use_fuzzy_logic": "1",
                      "correlation_mode": "Time"},
    "residual_color": {"scalar_field_idx_0": "0", "scalar_field_idx_1": "1"},
    "velocity": {}, "vector_magnitude": {}, "vorticity": {},
    "helicity": {},
    "dkl_calculator": {"scalar_field_idx": "0", "estimator_type": "k-NN"},
}


def correlation_node():
    return {"type": "correlation", "state": {
        "correlation_measure_type": "pearson", "scalar_field_idx": "0",
        "reference_point_x": "1", "reference_point_y": "2",
        "reference_point_z": "3"}}


def reference_doc(calculators):
    return {"global_camera": {"position": {"x": 0.2, "y": 0.3, "z": 0.7}},
            "views": [{"name": "3D View 1"}],
            "volume_data": {"name": "ens", "transfer_functions": []},
            "calculators": calculators, "renderers": []}


@pytest.mark.parametrize("type_id", A7_TYPES)
def test_reference_state_conversion_matches_jax(type_id):
    doc = reference_doc([correlation_node(),
                         {"type": type_id, "state": REFERENCE_NODES[type_id]},
                         {"type": "dkl", "state": {}}])
    if type_id in ("velocity", "vector_magnitude", "vorticity", "helicity",
                   "dkl_calculator"):
        # JAX's converter has no branch for these: both raise.
        for converter in (jax_state_ref, state_ref):
            with pytest.raises(ValueError, match="unknown calculator type"):
                converter.convert_reference_state(copy.deepcopy(doc),
                                                  ["data"])
        return
    want, want_warnings = jax_state_ref.convert_reference_state(
        copy.deepcopy(doc), ["data"])
    got, got_warnings = state_ref.convert_reference_state(
        copy.deepcopy(doc), ["data"])
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got_warnings == want_warnings
    if type_id == "set_predicate":
        assert any("fuzzy" in w for w in got_warnings)
        assert any("time-mode" in w for w in got_warnings)
    if type_id == "noise_reduction":
        assert any("'Median' not replicated" in w for w in got_warnings)


def test_dkl_node_converts_like_jax():
    # The "dkl" branch of the converter, reached directly (no registry
    # holds "dkl", so a state file skips it with a warning in both).
    state = {"scalar_field_idx": "0", "estimator_type": "k-NN",
             "mi_bins": "20", "knn_neighbors": "4"}
    args = (["data"], [])
    assert state_ref._convert_calculator("dkl", dict(state), *args) == \
        jax_state_ref._convert_calculator("dkl", dict(state), *args)


def test_reference_state_export_matches_jax():
    data = {"a": ensemble(23, shape=(4, 1, 3, 4, 5)),
            "b": ensemble(24, shape=(4, 1, 3, 4, 5))}
    jvd, tvd = volumes(data)
    jscene, tscene = JaxScene(jvd), Scene(tvd)
    for type_id in ("binary_operator", "noise_reduction", "ensemble_mean",
                    "set_predicate", "residual_color", "dkl_calculator"):
        settings = SETTINGS[type_id]
        jscene.add_calculator(jax_from_settings(type_id, dict(settings)))
        tscene.add_calculator(calculator_from_settings(type_id,
                                                       dict(settings)))
    want = jax_state_ref.reference_state_from_scene(jscene)
    got = state_ref.reference_state_from_scene(tscene)
    assert json.dumps(got["calculators"], sort_keys=True) == json.dumps(
        want["calculators"], sort_keys=True)
    # Read back without the DKL node, which JAX's converter refuses.
    doc = copy.deepcopy(got)
    doc["calculators"] = [c for c in doc["calculators"]
                          if c["type"] != "dkl_calculator"]
    back, _ = state_ref.convert_reference_state(copy.deepcopy(doc),
                                                ["a", "b"])
    want_back, _ = jax_state_ref.convert_reference_state(doc, ["a", "b"])
    assert json.dumps(back, sort_keys=True) == json.dumps(want_back,
                                                          sort_keys=True)
    assert [c["type"] for c in back["calculators"]] == [
        "binary_operator", "noise_reduction", "ensemble_mean",
        "set_predicate", "residual_color"]
