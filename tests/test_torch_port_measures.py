"""PyTorch port (correrender_tpu_torch) vs the JAX package: the rank and
mutual-information measures, their dispatch and the correlation field.

The same numpy inputs go through the JAX functions and the port on the
CPU, where every kernel wrapper runs its plain version; chip_smoke.py
holds the kernels to those plain versions on the card.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from correrender_tpu import ops as jops
from correrender_tpu.calculators.correlation import (
    correlate_field as jax_correlate_field,
)
from correrender_tpu.ops.mi_ksg import _SEED_QUERY, _SEED_REF

from correrender_tpu_torch import ops as tops
from correrender_tpu_torch.app import baseline_configs
from correrender_tpu_torch.calculators.correlation import (
    _auto_chunk,
    correlate_field,
    nan_bounds,
)
from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.mi_binned import (
    binned_mi_correlation_coefficient,
)
from correrender_tpu_torch.ops.mi_ksg import kmi_correlation_coefficient
from correrender_tpu_torch.ops.noise import (
    SEED_QUERY,
    SEED_REF,
    tie_break_noise,
    uniform_like_jax,
)
from correrender_tpu_torch.ops.registry import CorrelationMeasure

# The module, not the function ``ops.kendall`` that the package exports.
tkendall = importlib.import_module("correrender_tpu_torch.ops.kendall")

# Spearman: JAX sums the ranks in float32 (about 1e-7 of rounding at the
# tests' n); the port's plain version is exact.
ATOL_SPEARMAN = 2e-6
# Kendall: the same exact counts; XLA may contract the float32 assembly.
ATOL_KENDALL = 1e-6
# Binned MI and KSG: float32 sums in another order; the KSG noise is
# rounded once more than XLA's fused multiply-add (a boundary count
# could move only for a value within one ulp of it).
ATOL_MI = 1e-5
ALL_MEASURES = [m.value for m in CorrelationMeasure]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_close_nan(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# -- the tie-break noise -------------------------------------------------


@pytest.mark.parametrize("seed", [SEED_REF, SEED_QUERY])
@pytest.mark.parametrize("n", [1, 37, 128, 1000])
def test_noise_is_bit_identical_to_jax(seed, n):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), (n,),
                                         jnp.float32))
    got = uniform_like_jax(seed, n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_noise_seeds_are_the_jax_packages():
    assert (SEED_REF, SEED_QUERY) == (_SEED_REF, _SEED_QUERY)


def test_noise_is_cached_per_n_and_a_prefix_of_longer_draws():
    nx, ny = tie_break_noise(50)
    assert tie_break_noise(50)[0] is nx
    longer = tie_break_noise(80)
    assert torch.equal(longer[0][:50], nx) and torch.equal(longer[1][:50], ny)


# -- ranks, Spearman, Kendall ---------------------------------------------


def _rank_inputs(case):
    rng = np.random.default_rng(0)
    if case == "ties":
        y = rng.integers(0, 20, size=(6, 100)).astype(np.float32)
        x = rng.integers(0, 20, size=100).astype(np.float32)
    elif case == "unaligned":
        y = rng.normal(size=(7, 73)).astype(np.float32)
        x = rng.normal(size=73).astype(np.float32)
    else:  # NaN members, a zero-variance series
        y = rng.normal(size=(5, 40)).astype(np.float32)
        x = rng.normal(size=40).astype(np.float32)
        y[1, [3, 17]] = np.nan
        y[2, 8] = np.nan
        y[3] = 0.5
    return x, y


@pytest.mark.parametrize("case", ["ties", "unaligned", "nan"])
def test_fractional_ranks_match_jax(case):
    _, y = _rank_inputs(case)
    got = tops.fractional_ranks(t(y))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.fractional_ranks(y)))


@pytest.mark.parametrize("case", ["ties", "unaligned", "nan"])
def test_spearman_matches_jax(case):
    x, y = _rank_inputs(case)
    assert_close_nan(tops.spearman(t(x), t(y)),
                     jops.spearman(jnp.asarray(x), jnp.asarray(y)),
                     ATOL_SPEARMAN)


def test_spearman_takes_ranked_inputs():
    x, y = _rank_inputs("ties")
    rx, ry = tops.fractional_ranks(t(x)), tops.fractional_ranks(t(y))
    want = tops.spearman(t(x), t(y))
    assert torch.equal(tops.spearman(rx, t(y), x_is_ranked=True), want)
    assert torch.equal(tops.spearman(rx, ry, x_is_ranked=True,
                                     y_is_ranked=True), want)


@pytest.mark.parametrize("case", ["ties", "unaligned", "nan"])
def test_kendall_matches_jax(case):
    x, y = _rank_inputs(case)
    assert_close_nan(tops.kendall(t(x), t(y)),
                     jops.kendall(jnp.asarray(x), jnp.asarray(y)),
                     ATOL_KENDALL)


def test_kendall_integer_path_matches_jax():
    # n(n−1) ≥ 2²⁴: both packages switch to int32 pair counts.
    rng = np.random.default_rng(1)
    n = 4200
    x = rng.integers(0, 50, size=n).astype(np.float32)
    y = rng.integers(0, 50, size=(2, n)).astype(np.float32)
    y[1, 7] = np.nan
    assert tkendall._accumulator(n, None) == torch.int32
    assert_close_nan(tops.kendall(t(x), t(y)),
                     jops.kendall(jnp.asarray(x), jnp.asarray(y)),
                     ATOL_KENDALL)


def test_kendall_accumulator_rule():
    assert tkendall._accumulator(4096, None) == torch.float32
    assert tkendall._accumulator(46340, None) == torch.int32
    assert tkendall._accumulator(50000, torch.float64) == torch.float64
    with pytest.raises(ValueError, match="overflows int32"):
        tkendall._accumulator(46341, None)


def test_kendall_forces_joint_ties_to_zero():
    # Pairs tied in both x and y: the reference's n3 = 0 convention.
    x = np.array([1, 1, 2, 3, 3, 4], np.float32)
    y = np.array([5, 5, 1, 2, 2, 0], np.float32)
    assert_close_nan(tops.kendall(t(x), t(y)),
                     jops.kendall(jnp.asarray(x), jnp.asarray(y)), 1e-7)


# -- mutual information ---------------------------------------------------


def _mi_inputs(seed=2, n=80, v=6, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(0, 6, size=n).astype(np.float32)
        y = rng.integers(0, 6, size=(v, n)).astype(np.float32)
    else:
        x = rng.normal(size=n).astype(np.float32)
        y = rng.normal(size=(v, n)).astype(np.float32)
    y[: v // 2] = 0.7 * x + 0.5 * y[: v // 2]
    return x, y


@pytest.mark.parametrize("bounds", [None, (-3.0, 3.0),
                                    ((-2.5, 2.5), (-4.0, 4.0))])
@pytest.mark.parametrize("num_bins", [8, 80])
def test_mutual_information_binned_matches_jax(bounds, num_bins):
    x, y = _mi_inputs()
    y[2, 5] = np.nan  # a NaN pair is skipped
    kw = dict(num_bins=num_bins, mi_bounds=bounds)
    for measure in ("mi_binned", "binned_mi_correlation_coefficient"):
        assert_close_nan(tops.correlate(t(x), t(y), measure, **kw),
                         jops.correlate(jnp.asarray(x), jnp.asarray(y),
                                        measure, **kw), ATOL_MI)


@pytest.mark.parametrize("estimator", [1, 2])
@pytest.mark.parametrize("use_noise", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_mutual_information_kraskov_matches_jax(estimator, use_noise, ties):
    x, y = _mi_inputs(ties=ties)
    got = tops.mutual_information_kraskov(t(x), t(y), k=3,
                                          estimator=estimator,
                                          use_noise=use_noise)
    want = jops.mutual_information_kraskov(jnp.asarray(x), jnp.asarray(y),
                                           k=3, estimator=estimator,
                                           use_noise=use_noise)
    assert_close_nan(got, want, ATOL_MI)
    assert float(got[0]) > 0.1  # a correlated voxel carries information


def test_kraskov_takes_an_explicit_noise():
    x, y = _mi_inputs(ties=True)
    n = x.shape[0]
    noise = (uniform_like_jax(SEED_REF, n), uniform_like_jax(SEED_QUERY, n))
    default = tops.mutual_information_kraskov(t(x), t(y))
    assert torch.equal(
        tops.mutual_information_kraskov(t(x), t(y), noise=noise), default)
    zeros = (np.zeros(n, np.float32), np.zeros(n, np.float32))
    plain = tops.mutual_information_kraskov(t(x), t(y), use_noise=False)
    assert torch.equal(
        tops.mutual_information_kraskov(t(x), t(y), noise=zeros), plain)
    assert not torch.equal(default, plain)  # the noise breaks the ties


def test_kraskov_nan_member_gives_nan():
    # A departure by design: the JAX package's three KSG paths give three
    # different finite values for a series with a NaN member.
    x, y = _mi_inputs()
    y[1, 4] = np.nan
    got = tops.mutual_information_kraskov(t(x), t(y)).numpy()
    assert np.isnan(got[1]) and np.isfinite(np.delete(got, 1)).all()


def test_maximum_mutual_information_kraskov_matches_jax():
    for k, n in ((3, 100), (5, 1000)):
        assert tops.maximum_mutual_information_kraskov(k, n) == pytest.approx(
            jops.maximum_mutual_information_kraskov(k, n), abs=1e-12)


def test_mi_coefficients_match_jax():
    from correrender_tpu.ops.mi_binned import (
        binned_mi_correlation_coefficient as jbinned)
    from correrender_tpu.ops.mi_ksg import kmi_correlation_coefficient as jkmi

    mi = np.array([0.0, 0.1, 1.0, 3.0, np.nan], np.float32)
    for ours, theirs in ((binned_mi_correlation_coefficient, jbinned),
                         (kmi_correlation_coefficient, jkmi)):
        assert_close_nan(ours(t(mi)), theirs(jnp.asarray(mi)), 1e-7)


# -- the registry and the field -------------------------------------------


def test_measure_registry_matches_jax():
    from correrender_tpu.ops import registry as jreg

    assert {m.value: name for m, name in tops.MEASURE_NAMES.items()} == {
        m.value: name for m, name in jreg.MEASURE_NAMES.items()}
    for m in CorrelationMeasure:
        jm = jreg.CorrelationMeasure(m.value)
        for pred in ("is_measure_mi", "is_measure_binned_mi",
                     "is_measure_kraskov_mi",
                     "is_measure_correlation_coefficient_mi"):
            assert getattr(tops, pred)(m) == getattr(jreg, pred)(jm), pred


CORRELATE_KWARGS = {
    "pearson": {},
    "spearman": {"absolute": True},
    "kendall": {},
    "mi_binned": {"num_bins": 16},
    "mi_kraskov": {"k": 4, "kraskov_estimator": 2},
    "binned_mi_correlation_coefficient": {"num_bins": 32},
    "kmi_correlation_coefficient": {"absolute": True},
}


@pytest.mark.parametrize("measure", ALL_MEASURES)
def test_correlate_matches_jax(measure):
    x, y = _mi_inputs(seed=5)
    kw = CORRELATE_KWARGS[measure]
    assert_close_nan(tops.correlate(t(x), t(y), measure, **kw),
                     jops.correlate(jnp.asarray(x), jnp.asarray(y), measure,
                                    **kw), ATOL_MI)


def _field_stack():
    rng = np.random.default_rng(6)
    stack = rng.normal(size=(2, 3, 4, 60)).astype(np.float32)
    stack[0, :2] = 0.8 * stack[1, 1, 1] + 0.4 * stack[0, :2]
    stack[1, 2, 3, 7] = np.nan  # a NaN member (binned MI skips it)
    return stack


@pytest.mark.parametrize("measure", ALL_MEASURES)
def test_correlate_field_matches_jax(measure):
    stack = _field_stack()
    ref = stack[1, 1, 1].copy()
    kw = dict(CORRELATE_KWARGS[measure])
    got = correlate_field(t(stack), t(ref), measure, **kw)
    want = np.asarray(jax_correlate_field(jnp.asarray(stack),
                                          jnp.asarray(ref), measure, **kw))
    assert got.shape == stack.shape[:-1]
    if measure in ("mi_kraskov", "kmi_correlation_coefficient"):
        # The port gives NaN for the series with a NaN member (see
        # test_kraskov_nan_member_gives_nan); the rest agrees.
        assert np.isnan(got[1, 2, 3].item())
        got[1, 2, 3] = float(want[1, 2, 3])
    assert_close_nan(got, want, ATOL_MI)


@pytest.mark.parametrize("measure", ["spearman", "kendall", "mi_kraskov"])
def test_correlate_field_absolute_matches_jax(measure):
    stack = _field_stack()[..., :40].copy()
    stack[1, 2, 3, 7] = 0.0
    ref = -stack[1, 1, 1]
    got = correlate_field(t(stack), t(ref), measure, absolute=True)
    want = jax_correlate_field(jnp.asarray(stack), jnp.asarray(ref), measure,
                               absolute=True)
    assert (got >= 0).all()
    assert_close_nan(got, want, ATOL_MI)


def test_binned_field_uses_global_bounds():
    stack = _field_stack()
    ref = stack[0, 0, 0].copy()
    lo, hi = nan_bounds(t(stack))
    assert float(lo) == np.nanmin(stack) and float(hi) == np.nanmax(stack)
    bounds = ((float(ref.min()), float(ref.max())), (float(lo), float(hi)))
    assert torch.equal(correlate_field(t(stack), t(ref), "mi_binned"),
                       correlate_field(t(stack), t(ref), "mi_binned",
                                       mi_bounds=bounds))


def test_binned_field_is_chunked_under_the_budget():
    stack = _field_stack()
    ref = stack[0, 0, 0].copy()
    n = stack.shape[-1]
    small = 4 * n * 80 * 2 + 4 * 80 * 80  # one voxel per chunk
    assert _auto_chunk(n, small) == 1
    assert _auto_chunk(n, 3 * small) == 3
    assert torch.allclose(
        correlate_field(t(stack), t(ref), "mi_binned",
                        chunk_budget_bytes=small),
        correlate_field(t(stack), t(ref), "mi_binned"), atol=1e-6)


def test_cpu_field_never_counts_a_launch():
    stack = _field_stack()[..., :30].copy()
    _build.reset_launch_counts()
    for measure in ALL_MEASURES:
        correlate_field(t(stack), t(stack[0, 0, 0]), measure)
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


@pytest.mark.parametrize("config", [
    baseline_configs.config2_rank_correlations,
    baseline_configs.config3_mutual_information,
])
def test_configs_2_and_3_need_a_cuda_device(config):
    with pytest.raises(ValueError, match="CUDA"):
        config(device="cpu")


def test_karman_stack_is_the_jax_configs_draw():
    # correrender_tpu/app/baseline_configs.py:84-101, at a small grid.
    xs, ys, zs, members = 6, 5, 3, 4
    z, y, x = np.meshgrid(np.linspace(0, 1, zs), np.linspace(0, 1, ys),
                          np.linspace(0, 1, xs), indexing="ij")
    rng = np.random.default_rng(0)
    phases = rng.uniform(0, 2 * np.pi, members)
    want = np.stack([np.sin(12 * x - 3 * p) * np.cos(8 * y + p)
                     + 0.3 * rng.normal(size=x.shape) for p in phases],
                    axis=-1).astype(np.float32)
    np.testing.assert_array_equal(
        baseline_configs.karman_stack((xs, ys, zs), members), want)
