"""PyTorch port (``correrender_tpu_torch``) vs the JAX package: the HEB
chart and what it computes with — the ``jax.random`` draws of
``ops/noise.py``, ``correlate_requests``, the block-pair samplers, the
batched GP-UCB sampler, ``HEBChart`` and ``HEBDrilldown``.

The same seeded numpy inputs go through both packages (the JAX tests'
``box_stack``, 32×32×8 × 64, with 16 leaves at downsample 8). Bars: the
draws bit for bit; the measures' bars of ``tests/test_pallas.py`` and
the other ``test_torch_port_*`` files (Pearson 2e-5, Spearman 2e-6,
Kendall 1e-6, binned MI 1e-5, KSG 1e-5, the binned-MI correlation
coefficient 1e-5, and ``test_torch_port_pearson.py``'s 5e-5 for the KMI
coefficient, whose square root amplifies KSG's 1e-5 near zero). Chord
lists are equal pair for pair, except that pairs whose magnitudes agree
within the bar may trade places (a tie, ordered by rounding).

The batched GP-UCB departs from JAX on a pair only where one of its
discrete choices (the length-scale refit's argmax over a flat
likelihood, a UCB argmax) is a rounding tie: the port's loop run in
float64 takes one of the two branches there, and both maxima lie
between the pair's initial samples and its exhaustive maximum (ROADMAP
C pins the fixture's pairs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from correrender_tpu.calculators.correlation import (
    correlate_requests as jax_correlate_requests,
)
from correrender_tpu.diagrams import bayopt as jax_bayopt
from correrender_tpu.diagrams import sampling as jax_sampling
from correrender_tpu.diagrams.drilldown import HEBDrilldown as JaxDrilldown
from correrender_tpu.diagrams.heb import HEBChart as JaxHEB
from correrender_tpu.diagrams.octree import GridRegion as JaxRegion
from correrender_tpu.utils import fixtures as jfixtures

from correrender_tpu_torch.calculators.correlation import correlate_requests
from correrender_tpu_torch.diagrams import bayopt, sampling
from correrender_tpu_torch.diagrams.drilldown import HEBDrilldown
from correrender_tpu_torch.diagrams.heb import HEBChart, top_chords
from correrender_tpu_torch.diagrams.octree import GridRegion
from correrender_tpu_torch.ops import noise

#: Measure bars (see the module docstring).
BARS = {
    "pearson": 2e-5,
    "spearman": 2e-6,
    "kendall": 1e-6,
    "mi_binned": 1e-5,
    "mi_kraskov": 1e-5,
    "binned_mi_correlation_coefficient": 1e-5,
    "kmi_correlation_coefficient": 5e-5,
}


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


def jax_regions(regions):
    return [JaxRegion(r.x_min, r.y_min, r.z_min, r.x_max, r.y_max, r.z_max)
            for r in regions]


def assert_close_nan(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def assert_chords_match(got, want, bar):
    """The same chords in the same order, values within ``bar``; pairs
    whose magnitudes (the chart's ranking) are within ``bar`` of each
    other may trade places, and at the cut a pair may stand in for one
    whose magnitude it ties."""
    assert len(got) == len(want)
    if not want:
        return
    gv = np.abs([c[2] for c in got])
    wv = np.abs([c[2] for c in want])
    np.testing.assert_allclose(gv, wv, atol=bar, rtol=0)
    gd = {(i, j): v for i, j, v in got}
    wd = {(i, j): v for i, j, v in want}
    for key in gd.keys() & wd.keys():
        assert abs(gd[key] - wd[key]) <= bar, key
    cut = wv.min()
    for key in gd.keys() ^ wd.keys():
        v = gd.get(key, wd.get(key))
        assert abs(abs(v) - cut) <= bar, (key, v, cut)
    for k, (a, b) in enumerate(zip(got, want)):
        if a[:2] != b[:2]:
            assert abs(abs(a[2]) - abs(b[2])) <= bar, (k, a, b)


def chart_pair(stack, **kw):
    """The same chart in both packages, correlations computed."""
    j = JaxHEB(stack, **kw)
    j.compute_correlations()
    c = HEBChart(t(stack), **kw)
    c.compute_correlations()
    return j, c


# -- the draws ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 617406168])
@pytest.mark.parametrize("shape", [(7,), (512, 6), (3, 5, 2)])
def test_uniform_draws_equal_jax_bit_for_bit(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape))
    got = noise.uniform_like_jax(seed, shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
@pytest.mark.parametrize("data", [0, 1, 19, 59, 2**32 - 1])
def test_fold_in_and_its_draws_equal_jax(seed, data):
    key = jax.random.fold_in(jax.random.key(seed), data)
    got = noise.fold_in_like_jax(seed, data)
    assert got == tuple(int(v) for v in jax.random.key_data(key))
    np.testing.assert_array_equal(
        noise.uniform_like_jax(got, (64, 6)),
        np.asarray(jax.random.uniform(key, (64, 6))))
    np.testing.assert_array_equal(
        noise.normal_like_jax(got, (33,)).view(np.uint32),
        np.asarray(jax.random.normal(key, (33,))).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 42, 1234567])
@pytest.mark.parametrize("shape", [(400, 2), (5,), (2, 3, 4)])
def test_normal_draws_equal_jax_bit_for_bit(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = noise.normal_like_jax(seed, shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_normal_transform_equals_jax_on_every_uniform():
    # jax.random.normal maps each of the 2^23 float32 uniforms through
    # √2·erfinv; every 3rd of them (and both ends) here.
    m = np.concatenate([np.arange(0, 1 << 23, 3, dtype=np.uint32),
                        np.array([(1 << 23) - 1], np.uint32)])
    u = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    v = np.maximum(lo, u * np.float32(2) + lo)
    want = np.asarray(jax.jit(
        lambda a: jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(a))(v))
    got = np.float32(np.sqrt(2)) * noise._erfinv_xla(v)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_bayopt_candidates_are_the_fold_in_draws():
    got = bayopt.candidate_draws(7, 3, 16)
    for it in range(3):
        want = jax.random.uniform(
            jax.random.fold_in(jax.random.key(7), it), (16, 6))
        np.testing.assert_array_equal(got[it], np.asarray(want))


# -- correlate_requests ---------------------------------------------------


@pytest.mark.parametrize("measure", list(BARS))
def test_correlate_requests_matches_jax(box_stack, measure):
    rng = np.random.default_rng(3)
    stack = box_stack[:, :16, :16]
    req_a = rng.integers(0, [8, 16, 16], size=(96, 3))
    req_b = rng.integers(0, [8, 16, 16], size=(96, 3))
    flat_b = rng.integers(0, 8 * 16 * 16, size=96)
    stack_b = np.ascontiguousarray(stack[::-1] * 0.5 + 0.1)
    for args, kw in (((req_a, req_b), {}), ((req_a, flat_b), {}),
                     ((req_a, req_b), {"absolute": True})):
        want = jax_correlate_requests(jnp.asarray(stack), *args, measure,
                                      **kw)
        got = correlate_requests(t(stack), *args, measure, **kw)
        assert_close_nan(got.numpy(), want, BARS[measure])
    want = jax_correlate_requests(jnp.asarray(stack), req_a, req_b, measure,
                                  stack_b=jnp.asarray(stack_b))
    got = correlate_requests(t(stack), t(req_a), t(req_b), measure,
                             stack_b=t(stack_b))
    assert_close_nan(got.numpy(), want, BARS[measure])


# -- the samplers ---------------------------------------------------------


RA = GridRegion(0, 0, 2, 7, 7, 5)
RB = GridRegion(8, 0, 2, 15, 7, 5)


def test_sequences_are_the_jax_packages():
    idx = np.arange(1, 101)
    np.testing.assert_array_equal(sampling.halton(idx, 3),
                                  jax_sampling.halton(idx, 3))
    np.testing.assert_array_equal(sampling.plastic_sequence(100, 6),
                                  jax_sampling.plastic_sequence(100, 6))


@pytest.mark.parametrize("method", ["mean", "random", "halton", "plastic"])
@pytest.mark.parametrize("measure", ["pearson", "kendall"])
def test_per_pair_samplers_match_jax(box_stack, method, measure):
    (ja, jb), = [jax_regions([RA, RB])]
    want = jax_sampling.sample_block_pair_max(
        box_stack, ja, jb, measure, method=method, num_samples=48)
    got = sampling.sample_block_pair_max(t(box_stack), RA, RB, measure,
                                         method=method, num_samples=48)
    assert abs(got - want) <= BARS[measure]


def test_exhaustive_matches_jax_and_bounds_the_samplers(box_stack):
    ja, jb = jax_regions([RA, RB])
    want = jax_sampling.exhaustive_block_pair_max(box_stack, ja, jb)
    got = sampling.exhaustive_block_pair_max(t(box_stack), RA, RB)
    assert abs(got - want) <= BARS["pearson"]
    est = sampling.sample_block_pair_max(t(box_stack), RA, RB,
                                         method="plastic", num_samples=64)
    assert 0.5 * got < est <= got + 1e-5


def _leaf_pairs(stack, factor=8):
    chart = HEBChart(t(stack), downsample_factor=factor)
    iu, ju = np.triu_indices(chart.num_leaves, k=1)
    return ([chart._upscale(chart.leaves[i]) for i in iu],
            [chart._upscale(chart.leaves[j]) for j in ju])


@pytest.mark.parametrize("method", ["random", "halton", "plastic"])
@pytest.mark.parametrize("measure", list(BARS))
def test_batched_samplers_match_jax(box_stack, method, measure):
    ra, rb = _leaf_pairs(box_stack)
    ra, rb = ra[::3], rb[::3]
    want = jax_sampling.batched_block_pairs_max(
        box_stack, jax_regions(ra), jax_regions(rb), measure, method=method,
        num_samples=12)
    got = sampling.batched_block_pairs_max(t(box_stack), ra, rb, measure,
                                           method=method, num_samples=12)
    assert got.shape == (len(ra),) and got.dtype == np.float32
    assert_close_nan(got, want, BARS[measure])


def test_batched_samplers_chunking_and_per_pair_loop(box_stack):
    ra, rb = _leaf_pairs(box_stack)
    ra, rb = ra[:40], rb[:40]
    whole = sampling.batched_block_pairs_max(t(box_stack), ra, rb,
                                             num_samples=24)
    chunked = sampling.batched_block_pairs_max(
        t(box_stack), ra, rb, num_samples=24, request_chunk=24 * 7)
    np.testing.assert_array_equal(whole, chunked)
    looped = [sampling.sample_block_pair_max(t(box_stack), a, b,
                                             num_samples=24)
              for a, b in zip(ra, rb)]
    np.testing.assert_allclose(whole, looped, atol=1e-6, rtol=0)


def test_request_chunk_rule():
    # JAX's 128 MB gather rule bounds Pearson; the port's working sets
    # (KSG's (n, n) rows, Kendall's tiles, the binned one-hot rows) bound
    # the others under the device's budget; a power of two.
    cpu, card = torch.device("cpu"), torch.device("cuda")
    for dev in (cpu, card):
        assert sampling.request_chunk_size("pearson", 100, dev) == 131072
        assert sampling.request_chunk_size("spearman", 100, dev) == 131072
    assert sampling.request_chunk_size("mi_kraskov", 100, cpu) == 2048
    assert sampling.request_chunk_size("mi_kraskov", 100, card) == 32768
    assert sampling.request_chunk_size("kendall", 100, card) == 16384
    for m in ("mi_binned", "binned_mi_correlation_coefficient"):
        c = sampling.request_chunk_size(m, 100, cpu)
        assert c & (c - 1) == 0 and 256 <= c < 131072
        assert c * sampling.request_bytes(m, 100) <= 512 << 20
    assert sampling.request_chunk_size("mi_kraskov", 4000, cpu) == 256


def test_ksg_and_scalar_bounds_through_the_batched_sampler():
    rng = np.random.default_rng(0)
    stack = rng.standard_normal((8, 8, 8, 64)).astype(np.float32)
    ra, rb = [GridRegion(0, 0, 0, 3, 3, 3)], [GridRegion(4, 4, 4, 7, 7, 7)]
    want = jax_sampling.batched_block_pairs_max(
        stack, jax_regions(ra), jax_regions(rb), "mi_binned", num_samples=8,
        num_bins=8, mi_bounds=((np.float32(-4), np.float32(4)),) * 2)
    got = sampling.batched_block_pairs_max(
        t(stack), ra, rb, "mi_binned", num_samples=8, num_bins=8,
        mi_bounds=((-4.0, 4.0),) * 2)
    assert_close_nan(got, want, BARS["mi_binned"])
    out = sampling.batched_block_pairs_max(t(stack), ra, rb, "mi_kraskov",
                                           num_samples=16)
    assert out.shape == (1,) and np.isfinite(out[0])


def _anti(seed, shape, split_axis, n):
    rng = np.random.default_rng(seed)
    sig = rng.normal(size=n).astype(np.float32)
    stack = rng.normal(size=shape + (n,)).astype(np.float32) * 0.05
    half = shape[split_axis] // 2
    lo = [slice(None)] * 3
    hi = [slice(None)] * 3
    lo[split_axis], hi[split_axis] = slice(None, half), slice(half, None)
    stack[tuple(lo)] += sig
    stack[tuple(hi)] -= sig
    return stack


def test_signed_samplers_pick_the_strongest_magnitude():
    stack = _anti(3, (8, 8, 8), 0, 32)
    ra, rb = GridRegion(0, 0, 0, 7, 7, 3), GridRegion(0, 0, 4, 7, 7, 7)
    ja, jb = jax_regions([ra, rb])
    for fn, jfn, args in (
            (sampling.sample_block_pair_max,
             jax_sampling.sample_block_pair_max,
             dict(method="plastic", num_samples=16)),
            (sampling.exhaustive_block_pair_max,
             jax_sampling.exhaustive_block_pair_max, {})):
        got = fn(t(stack), ra, rb, "pearson", absolute=False, **args)
        want = jfn(stack, ja, jb, "pearson", absolute=False, **args)
        assert got < -0.5 and abs(got - want) <= BARS["pearson"]
    got = sampling.batched_block_pairs_max(t(stack), [ra], [rb],
                                           method="plastic", num_samples=16,
                                           absolute=False)
    want = jax_sampling.batched_block_pairs_max(
        stack, [ja], [jb], method="plastic", num_samples=16, absolute=False)
    assert got[0] < -0.5
    assert_close_nan(got, want, BARS["pearson"])


def test_all_nan_pairs_give_nan():
    stack = np.full((4, 4, 4, 8), np.nan, np.float32)
    r = GridRegion(0, 0, 0, 3, 3, 3)
    assert np.isnan(sampling.exhaustive_block_pair_max(t(stack), r, r))
    assert np.isnan(sampling.batched_block_pairs_max(t(stack), [r], [r],
                                                     num_samples=4)[0])
    rng = np.random.default_rng(0)
    stack = rng.normal(size=(4, 8, 8, 16)).astype(np.float32)
    stack[:, :4] = np.nan  # masked half
    good = GridRegion(0, 4, 0, 7, 7, 3)
    masked = GridRegion(0, 0, 0, 7, 3, 3)
    got = bayopt.batched_bayesian_opt_max(
        t(stack), [masked, good], [masked, good], num_init=6, num_iters=4)
    want = jax_bayopt.batched_bayesian_opt_max(
        stack, jax_regions([masked, good]), jax_regions([masked, good]),
        num_init=6, num_iters=4)
    assert np.isnan(got[0]) and np.isfinite(got[1])
    assert_close_nan(got, want, BARS["pearson"])


# -- Bayesian optimization ------------------------------------------------


def test_gp_pieces_match_jax():
    rng = np.random.default_rng(1)
    x = rng.random((20, 6)).astype(np.float32)
    y = rng.standard_normal(20).astype(np.float32)
    q = rng.random((32, 6)).astype(np.float32)
    np.testing.assert_allclose(
        bayopt.matern52(t(x), t(q), 0.3, 1.5).numpy(),
        np.asarray(jax_bayopt.matern52(jnp.asarray(x), jnp.asarray(q), 0.3,
                                       1.5)), atol=1e-6, rtol=0)
    cap = 32
    xp = np.zeros((cap, 6), np.float32)
    xp[:20] = x
    yp = np.zeros(cap, np.float32)
    yp[:20] = y
    mask = np.zeros(cap, np.float32)
    mask[:20] = 1.0
    for args in ((x, y, None), (xp, yp, mask)):
        xx, yy, mm = args
        jm, js = jax_bayopt.gp_posterior(
            jnp.asarray(xx), jnp.asarray(yy), jnp.asarray(q), 0.3, 1.0,
            mask=None if mm is None else jnp.asarray(mm))
        gm, gs = bayopt.gp_posterior(t(xx), t(yy), t(q), 0.3, 1.0,
                                     mask=None if mm is None else t(mm))
        np.testing.assert_allclose(gm.numpy(), np.asarray(jm), atol=1e-5)
        np.testing.assert_allclose(gs.numpy(), np.asarray(js), atol=1e-5)
        jl, jv = jax_bayopt.fit_gp_hyperparams(
            jnp.asarray(xx), jnp.asarray(yy),
            mask=None if mm is None else jnp.asarray(mm))
        gl, gv = bayopt.fit_gp_hyperparams(
            t(xx), t(yy), mask=None if mm is None else t(mm))
        assert float(gl) == float(jl)
        np.testing.assert_allclose(float(gv), float(jv), rtol=1e-5)


def test_gp_hyperparam_fit_recovers_scale():
    rng = np.random.default_rng(0)
    x = rng.random((60, 2)).astype(np.float32)
    k = bayopt.matern52(t(x), t(x), 0.15, 1.0).double().numpy()
    y = rng.multivariate_normal(np.zeros(60), k + 1e-6 * np.eye(60))
    ls, _ = bayopt.fit_gp_hyperparams(t(x), t(y.astype(np.float32)))
    assert 0.05 <= float(ls) <= 0.3


def test_per_pair_bayopt_matches_jax(box_stack):
    ja, jb = jax_regions([RA, RB])
    for absolute in (True, False):
        want = jax_bayopt.bayesian_opt_max(box_stack, ja, jb, num_init=10,
                                           num_iters=6, absolute=absolute)
        got = bayopt.bayesian_opt_max(t(box_stack), RA, RB, num_init=10,
                                      num_iters=6, absolute=absolute)
        assert abs(got - want) <= BARS["pearson"]


@pytest.fixture(scope="module")
def bayes_runs(box_stack):
    """The 120 leaf pairs' batched GP-UCB maxima: JAX, the port in
    float32 and the port's loop in float64 (HEB's 20 + 4 samples)."""
    ra, rb = _leaf_pairs(box_stack)
    want = jax_bayopt.batched_bayesian_opt_max(
        box_stack, jax_regions(ra), jax_regions(rb), num_init=20,
        num_iters=4)
    got = bayopt.batched_bayesian_opt_max(t(box_stack), ra, rb,
                                          num_init=20, num_iters=4)
    f64 = bayopt.batched_bayesian_opt_max(t(box_stack).double(), ra, rb,
                                          num_init=20, num_iters=4)
    return ra, rb, want, got, f64


def test_batched_bayopt_matches_jax_but_for_rounding_ties(box_stack,
                                                          bayes_runs):
    ra, rb, want, got, f64 = bayes_runs
    bar = BARS["pearson"]
    departs = np.flatnonzero(np.abs(got - want) > bar)
    # The pairs ROADMAP C pins part on a rounding tie of the refit's
    # argmax; at most a few of the 120 may.
    assert len(departs) <= 4, departs
    init = sampling.batched_block_pairs_max(
        t(box_stack), [ra[k] for k in departs], [rb[k] for k in departs],
        method="plastic", num_samples=20)
    for k, first in zip(departs, init):
        # The exact (float64) loop takes one of the two branches, and both
        # packages' maxima lie between the pair's initial samples and the
        # exhaustive maximum.
        assert min(abs(f64[k] - got[k]), abs(f64[k] - want[k])) <= bar
        truth = sampling.exhaustive_block_pair_max(t(box_stack), ra[k],
                                                   rb[k])
        for v in (got[k], want[k]):
            assert first - bar <= v <= truth + 1e-5


def test_batched_bayopt_chunks_signs_and_zero_iterations(box_stack):
    ra, rb = _leaf_pairs(box_stack)
    ra, rb = ra[:6], rb[:6]
    whole = bayopt.batched_bayesian_opt_max(t(box_stack), ra, rb,
                                            num_init=16, num_iters=6)
    chunked = bayopt.batched_bayesian_opt_max(t(box_stack), ra, rb,
                                              num_init=16, num_iters=6,
                                              pair_chunk=4)
    np.testing.assert_allclose(whole, chunked, atol=1e-6, rtol=0)
    stack = _anti(5, (8, 16, 16), 2, 48)
    ra, rb = [GridRegion(0, 0, 0, 7, 15, 7)], [GridRegion(8, 0, 0, 15, 15, 7)]
    sgn = bayopt.batched_bayesian_opt_max(t(stack), ra, rb, num_init=12,
                                          num_iters=12, absolute=False)
    ab = bayopt.batched_bayesian_opt_max(t(stack), ra, rb, num_init=12,
                                         num_iters=12)
    want = jax_bayopt.batched_bayesian_opt_max(
        stack, jax_regions(ra), jax_regions(rb), num_init=12, num_iters=12,
        absolute=False)
    assert sgn[0] < -0.5 and abs(abs(sgn[0]) - ab[0]) <= 1e-6
    assert_close_nan(sgn, want, BARS["pearson"])
    for absolute in (True, False):
        zero = bayopt.batched_bayesian_opt_max(
            t(stack), ra, rb, num_init=16, num_iters=0, absolute=absolute)
        want = jax_bayopt.batched_bayesian_opt_max(
            stack, jax_regions(ra), jax_regions(rb), num_init=16,
            num_iters=0, absolute=absolute)
        assert_close_nan(zero, want, BARS["pearson"])
    assert zero[0] < -0.5


# -- the HEB chart --------------------------------------------------------


@pytest.mark.parametrize("method,measure", [
    ("mean", m) for m in BARS] + [
    (s, "pearson") for s in ("random", "halton", "plastic")] + [
    ("plastic", m) for m in ("spearman", "kendall", "mi_binned",
                             "mi_kraskov")])
def test_heb_chords_match_jax(box_stack, method, measure):
    j, c = chart_pair(box_stack, downsample_factor=8, measure=measure,
                      sampling_method=method, num_samples=12, max_chords=30)
    assert c.num_leaves == j.num_leaves == 16
    np.testing.assert_allclose(c.leaf_stddev, j.leaf_stddev, atol=1e-6)
    assert_close_nan(c._pair_values[2], j._pair_values[2], BARS[measure])
    assert_chords_match(c.chords, j.chords, BARS[measure])
    assert "<svg" in c.render_svg(size=300)


def test_heb_svg_equals_jax_on_equal_chords(box_stack):
    j, c = chart_pair(box_stack, downsample_factor=8, measure="kendall",
                      max_chords=20)
    assert c.chords == j.chords
    assert c.render_svg(size=400) == j.render_svg(size=400)
    assert c.render_matrix_svg(size=300) == j.render_matrix_svg(size=300)
    for kw in ({"curve_thickness": 3.0}, {"opacity_by_value": False},
               {"highlight": c.chords[0][:2], "outer_ring_size_pct": 0.1}):
        assert c.render_svg(size=300, **kw) == j.render_svg(size=300, **kw)
    np.testing.assert_array_equal(c.pair_matrix(), j.pair_matrix())


def test_heb_bayesian_chart_matches_jax(box_stack, bayes_runs):
    _, _, want, got, _ = bayes_runs
    ties = np.flatnonzero(np.abs(got - want) > BARS["pearson"])
    for screening in (True, False):
        j, c = chart_pair(box_stack, downsample_factor=8,
                          sampling_method="bayesian", num_samples=24,
                          max_chords=10, bayesian_screening=screening)
        keep = ~np.isin(np.arange(len(c._pair_values[2])), ties)
        assert_close_nan(c._pair_values[2][keep], j._pair_values[2][keep],
                         BARS["pearson"])
        assert_chords_match(c.chords, j.chords, BARS["pearson"])
        assert all(0 <= v <= 1.0 + 1e-6 for _, _, v in c.chords)


def test_heb_filters_and_factors_match_jax(box_stack):
    for kw in ({"downsample_factor": (8, 8, 2)},
               {"correlation_range": (0.3, 0.8), "max_chords": 999},
               {"cell_distance_range": (2.0, 100.0), "max_chords": 999},
               {"cell_distance_range": (1000.0, 2000.0)},
               {"octree_mode": "zorder"},
               {"threshold": 0.5, "color_map": "Viridis",
                "color_map_variance": "Cividis"}):
        j, c = chart_pair(box_stack, **{"downsample_factor": 8, **kw})
        assert c.means.shape == j.means.shape
        # Block means of up to 512 float32 voxels, summed in another
        # order than numpy's pairwise sum.
        np.testing.assert_allclose(c.means.numpy(), j.means, atol=4e-6,
                                   rtol=0)
        assert_chords_match(c.chords, j.chords, BARS["pearson"])
        assert [c.leaf_label(k) for k in range(c.num_leaves)] == [
            j.leaf_label(k) for k in range(j.num_leaves)]
        assert "<svg" in c.render_svg(size=200)


def test_heb_signed_chart_matches_jax():
    stack = _anti(11, (8, 16, 16), 2, 24)
    for method in ("mean", "plastic"):
        j, c = chart_pair(stack, downsample_factor=8, sampling_method=method,
                          num_samples=12, absolute=False,
                          correlation_range=(-1.0, 1.0), max_chords=40)
        assert any(v < -0.5 for _, _, v in c.chords)
        assert_chords_match(c.chords, j.chords, BARS["pearson"])
        svg = c.render_svg()
        assert 'stroke-width="-' not in svg


def test_top_chords_ranks_by_magnitude_within_the_range():
    iu, ju = np.array([0, 0, 1, 2]), np.array([1, 2, 2, 3])
    flat = np.array([0.2, -0.9, np.nan, 0.5], np.float32)
    assert [c[:2] for c in top_chords(iu, ju, flat, (-1.0, 1.0), 2)] == [
        (0, 2), (2, 3)]
    assert top_chords(iu, ju, flat, (0.0, np.inf), 9)[0][:2] == (2, 3)


def test_unknown_sampling_method_raises():
    stack = np.random.default_rng(0).normal(size=(4, 16, 16, 8)).astype(
        np.float32)
    chart = HEBChart(t(stack), downsample_factor=8, sampling_method="halto")
    with pytest.raises(ValueError, match="sampling method"):
        chart.compute_correlations()


def test_default_sampling_is_the_jax_packages_mean(box_stack):
    # The reference app samples quasirandom plastic by default; the JAX
    # package's default is "mean" (ROADMAP C), and the port keeps it.
    assert HEBChart(t(box_stack)).sampling_method == "mean"
    assert JaxHEB(box_stack).sampling_method == "mean"


class _HostGuard(torch.Tensor):
    """A tensor whose large descendants refuse to go to the host."""

    limit = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in ("numpy", "cpu", "tolist", "__array__"):
            src = args[0]
            if isinstance(src, torch.Tensor) and src.numel() >= cls.limit:
                raise AssertionError(f"host copy of {tuple(src.shape)}")
        return super().__torch_function__(func, types, args, kwargs)


@pytest.mark.parametrize("method", ["mean", "plastic", "bayesian"])
def test_heb_chart_keeps_the_stack_on_its_device(box_stack, method):
    # Any tensor of at least a quarter of the stack's elements that is
    # copied to the host raises; the chart still computes and draws.
    _HostGuard.limit = box_stack.size // 4
    stack = t(box_stack).as_subclass(_HostGuard)
    with pytest.raises(AssertionError, match="host copy"):
        stack.cpu()
    chart = HEBChart(stack, downsample_factor=8, sampling_method=method,
                     num_samples=24, max_chords=10)
    chart.compute_correlations()
    assert chart.chords and "<svg" in chart.render_svg(size=200)


# -- the drill-down stack -------------------------------------------------


def test_drilldown_matches_jax(box_stack):
    kw = dict(downsample_factor=8, max_chords=20)
    j = JaxDrilldown(box_stack, **kw)
    d = HEBDrilldown(t(box_stack), **kw)
    assert_chords_match(d.current_chart().chords, j.current_chart().chords,
                        BARS["pearson"])
    jf = j.drill_into_chord(0)
    df = d.drill_into_chord(0)
    assert df.factors == jf.factors and df.offset == jf.offset
    assert tuple(df.stack.shape) == jf.stack.shape
    assert d.selected_regions() == [GridRegion(*vars(r).values())
                                    for r in j.selected_regions()]
    assert d.drilled_leaf_pairs == j.drilled_leaf_pairs
    assert_chords_match(df.chords, jf.chords, BARS["pearson"])
    assert [df.leaf_label(k) for k in range(df.num_leaves)] == [
        jf.leaf_label(k) for k in range(jf.num_leaves)]
    if d.current_chart().chords == j.current_chart().chords:
        assert d.render_context_svg(size=300) == j.render_context_svg(
            size=300)
    d.pop()
    j.pop()
    assert d.depth == j.depth == 1


def test_drilldown_focus_overrides_and_factors_match_jax(box_stack):
    kw = dict(downsample_factor=(8, 8, 2), max_chords=20,
              focus_sampling_method="plastic", focus_num_samples=9)
    j = JaxDrilldown(box_stack, **kw)
    d = HEBDrilldown(t(box_stack), **kw)
    df, jf = d.drill_into_chord(0), j.drill_into_chord(0)
    assert (df.sampling_method, df.num_samples) == ("plastic", 9)
    assert df.factors == jf.factors == (4, 4, 1)
    assert_chords_match(df.chords, jf.chords, BARS["pearson"])


def test_drill_without_chords_raises():
    rng = np.random.default_rng(0)
    stack = rng.normal(size=(8, 16, 16, 12)).astype(np.float32)
    d = HEBDrilldown(t(stack), downsample_factor=8,
                     correlation_range=(2.0, 3.0))
    with pytest.raises(ValueError, match="no chords"):
        d.drill_into_chord(0)
