"""PyTorch port (correrender_tpu_torch) vs the JAX package: Pearson.

The same numpy inputs go through the JAX functions (XLA, and the Pallas
kernel in interpret mode) and the port on the CPU, where the K1 wrapper
runs its plain version. The kernel itself is held to that plain version
on the card by chip_smoke.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu import ops as jops
from correrender_tpu.calculators.correlation import (
    correlate_field as jax_correlate_field,
)
from correrender_tpu.ops.pallas import pearson_pallas
from correrender_tpu.utils import fixtures as jfixtures

from correrender_tpu_torch.calculators.correlation import correlate_field
from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.pearson_kernel import (
    pearson_cuda,
    pearson_plain,
)
from correrender_tpu_torch.ops.registry import (
    CorrelationMeasure,
    correlate,
    measure_from_id,
)
from correrender_tpu_torch.utils import fixtures as tfixtures

# The module, not the function ``ops.pearson`` that the package exports.
tpearson = importlib.import_module("correrender_tpu_torch.ops.pearson")

ATOL = 2e-5  # tests/test_pallas.py:26


def _synth_box_stack():
    data = jfixtures.synth_box_ensemble(xs=8, ys=4, zs=2, members=100)
    return np.ascontiguousarray(np.moveaxis(data, 0, -1))  # (2, 4, 8, 100)


def _inputs(case):
    rng = np.random.default_rng(0)
    if case == "synth_box":
        stack = _synth_box_stack()
        return stack, stack[1, 2, 3].copy()
    if case == "unaligned":
        return (rng.normal(size=(37, 73)).astype(np.float32),
                rng.normal(size=73).astype(np.float32))
    stack = rng.normal(size=(6, 50)).astype(np.float32)
    stack[2] = 0.0  # a zero-variance series
    return stack, rng.normal(size=50).astype(np.float32)


def _assert_close_nan(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("case", ["synth_box", "unaligned", "zero_variance"])
def test_pearson_kernel_wrapper_matches_jax(case):
    stack, ref = _inputs(case)
    got = pearson_cuda(torch.from_numpy(stack), torch.from_numpy(ref))
    assert got.dtype == torch.float32 and got.shape == stack.shape[:-1]
    want_xla = jops.pearson(jnp.asarray(ref), jnp.asarray(stack))
    want_pallas = pearson_pallas(jnp.asarray(stack), jnp.asarray(ref),
                                 tile_v=16, interpret=True)
    _assert_close_nan(got.numpy(), want_xla, ATOL)
    _assert_close_nan(got.numpy(), want_pallas, ATOL)


def test_zero_variance_series_gives_nan():
    stack, ref = _inputs("zero_variance")
    got = pearson_cuda(torch.from_numpy(stack), torch.from_numpy(ref))
    assert np.isnan(got[2].item())
    assert np.isfinite(np.delete(got.numpy(), 2)).all()


@pytest.mark.parametrize("case", ["synth_box", "unaligned"])
def test_pearson_plain_matches_float64(case):
    stack, ref = _inputs(case)
    n = stack.shape[-1]
    got = pearson_plain(torch.from_numpy(stack).reshape(-1, n),
                        torch.from_numpy(ref))
    want = tpearson.pearson(torch.from_numpy(ref), torch.from_numpy(stack),
                            dtype=torch.float64).reshape(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_pearson_broadcasts_like_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 1, 40)).astype(np.float32)
    y = rng.normal(size=(1, 5, 40)).astype(np.float32)
    got = tpearson.pearson(torch.from_numpy(x), torch.from_numpy(y))
    want = jops.pearson(jnp.asarray(x), jnp.asarray(y))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_moments_and_from_sums_match_jax():
    from correrender_tpu.ops.pearson import (
        pearson_from_sums as jax_from_sums,
        pearson_moments as jax_moments,
    )

    rng = np.random.default_rng(4)
    y = rng.normal(size=(7, 30)).astype(np.float32)
    x = rng.normal(size=30).astype(np.float32)
    for got, want in zip(tpearson.pearson_moments(torch.from_numpy(y)),
                         jax_moments(jnp.asarray(y))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    sums = (x.sum(), y.sum(-1), (x * y).sum(-1), (x * x).sum(),
            (y * y).sum(-1))
    got = tpearson.pearson_from_sums(
        30, *(torch.as_tensor(np.float32(s)) for s in sums))
    want = jax_from_sums(30, *(jnp.asarray(s, jnp.float32) for s in sums))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_correlate_field_matches_jax():
    stack = _synth_box_stack()
    ref = stack[0, 1, 6].copy()
    got = correlate_field(torch.from_numpy(stack), torch.from_numpy(ref),
                          "pearson")
    want = jax_correlate_field(jnp.asarray(stack), jnp.asarray(ref),
                               "pearson")
    assert got.shape == (2, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_correlate_pearson_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=25).astype(np.float32)
    y = rng.normal(size=(4, 25)).astype(np.float32)
    got = correlate(torch.from_numpy(x), torch.from_numpy(y), "pearson")
    want = jops.correlate(jnp.asarray(x), jnp.asarray(y), "pearson")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# Began as a pin of the measures the first slices left out; they are
# ported now, and each case holds its measure to the JAX package.
@pytest.mark.parametrize("measure,step", [
    ("spearman", "A.8"), ("kendall", "A.8"), ("mi_binned", "A.9"),
    ("mi_kraskov", "A.9"), ("binned_mi_correlation_coefficient", "A.9"),
    ("kmi_correlation_coefficient", "A.9"),
])
def test_unported_measures_name_their_roadmap_step(measure, step):
    stack = _synth_box_stack()
    ref = stack[0, 1, 6].copy()
    # KSG's MI agrees to 1e-6 here; sqrt(1 − exp(−2·MI)) multiplies that
    # by its slope, about 1/sqrt(2·MI) = 5 at MI = 0.02.
    atol = 5e-5 if measure == "kmi_correlation_coefficient" else 1e-5
    got = correlate(torch.from_numpy(ref), torch.from_numpy(stack), measure)
    want = jops.correlate(jnp.asarray(ref), jnp.asarray(stack), measure)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    got = correlate_field(torch.from_numpy(stack), torch.from_numpy(ref),
                          measure)
    want = jax_correlate_field(jnp.asarray(stack), jnp.asarray(ref), measure)
    assert got.shape == stack.shape[:-1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_measure_ids_match_jax():
    from correrender_tpu.ops.registry import (
        CorrelationMeasure as JaxMeasure,
    )

    assert [m.value for m in CorrelationMeasure] == [
        m.value for m in JaxMeasure]
    assert measure_from_id("pearson") is CorrelationMeasure.PEARSON
    with pytest.raises(ValueError):
        measure_from_id("nope")


def test_per_voxel_reference_series_match_jax():
    # Each voxel's series against the same voxel's series of a second
    # stack (SEPARATE_SYMMETRIC mode), as JAX's chunked path computes it.
    rng = np.random.default_rng(4)
    stack = rng.normal(size=(2, 3, 4, 9)).astype(np.float32)
    ref = (stack + rng.normal(size=stack.shape)).astype(np.float32)
    ref[0, 1, 2] = 0.0  # a zero reference series: 0/0 = NaN
    want = np.asarray(jax_correlate_field(jnp.asarray(stack),
                                          jnp.asarray(ref), "pearson"))
    got = correlate_field(torch.from_numpy(stack), torch.from_numpy(ref))
    assert got.shape == (2, 3, 4) and bool(torch.isnan(got[0, 1, 2]))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("stack,ref,exc", [
    (torch.zeros((4, 8), dtype=torch.float64), torch.zeros(8), TypeError),
    (torch.zeros((4, 8)), torch.zeros(7), ValueError),
    (torch.zeros((4, 8), device="meta"), torch.zeros(8, device="meta"),
     ValueError),
])
def test_pearson_wrapper_rejects_bad_input(stack, ref, exc):
    with pytest.raises(exc):
        pearson_cuda(stack, ref)


def test_cpu_tensor_never_counts_a_launch():
    _build.reset_launch_counts()
    stack, ref = _inputs("unaligned")
    pearson_cuda(torch.from_numpy(stack), torch.from_numpy(ref))
    assert _build.LAUNCHES["pearson"] == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_source_hash_covers_every_kernel_source():
    names = sorted(p.name for p in _build._sources())
    assert names == ["classify.cu", "kendall.cu", "ksg.cu", "ksg_banded.cu",
                     "moments.cu", "pearson.cu", "raymarch.cu", "shearwarp.cu",
                     "spearman.cu"]
    assert _build._source_hash() == _build._source_hash()


def test_lambda_field_torch_matches_numpy():
    want = jfixtures.synth_box_lambda_field(xs=24, ys=20, zs=8)
    got = tfixtures.synth_box_lambda_field_torch(xs=24, ys=20, zs=8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_synth_box_stack_is_seeded_and_planted():
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tfixtures.synth_box_stack(16, 16, 4, 60, gen)

    a, b, c = draw(0), draw(0), draw(1)
    assert a.shape == (4, 16, 16, 60) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    # Inside a planted box (λ = 1) every series is the shared ramp.
    field = correlate_field(a, a[2, 2, 2])
    assert field[2, 1, 1].item() > 0.99
    assert abs(field[2, 12, 3].item()) < 0.5


@pytest.mark.parametrize("name,args", [
    ("peak_profile", (np.linspace(-1.5, 1.5, 61),)),
    ("peak_profile", (np.array([[0.0, 0.5], [0.99, 1.0]]),)),
    ("synth_box_lambda_field", ()),
    ("synth_box_lambda_field", (24, 20, 8)),
    ("synth_box_lambda_field", (9, 7, 5)),
    ("synth_box_ensemble", ()),
    ("synth_box_ensemble", (16, 12, 8, 30)),
    ("synth_box_ensemble", (9, 7, 5, 11, False, 3)),
    ("synth_box_ensemble", (8, 4, 2, 100, True, 0, np.float64)),
])
def test_fixtures_equal_the_jax_package_generators(name, args):
    # The port keeps its own numpy copies; they must give the same arrays.
    got = getattr(tfixtures, name)(*args)
    want = getattr(jfixtures, name)(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
