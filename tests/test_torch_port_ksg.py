"""PyTorch port (correrender_tpu_torch) vs the JAX package: the plain
versions of kernels B7 (Spearman), B8 (Kendall), B9 (KSG) and B10
(banded KSG) against the JAX package's Pallas kernels in interpret mode,
on the cases of tests/test_pallas.py, and the wrappers' CPU dispatch.

The CUDA kernels are held to these plain versions on the card by
chip_smoke.py (counts equal, fields within 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu.ops.mi_ksg import mutual_information_kraskov as jksg
from correrender_tpu.ops.pallas import mi_ksg_pallas
from correrender_tpu.ops.pallas.common import digamma_vpu
from correrender_tpu.ops.pallas.kendall_kernel import kendall_pallas
from correrender_tpu.ops.pallas.ksg_banded import mi_ksg_banded as jbanded
from correrender_tpu.ops.pallas.spearman_kernel import spearman_pallas
from correrender_tpu.utils import fixtures as jfixtures

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.kendall_kernel import (
    kendall_cuda,
    kendall_plain,
)
from correrender_tpu_torch.ops.cuda.ksg_banded import (
    band_width,
    mi_ksg_banded,
    mi_ksg_banded_plain,
)
from correrender_tpu_torch.ops.cuda.ksg_kernel import (
    check_ksg_args,
    mi_ksg_cuda,
    mi_ksg_plain,
)
from correrender_tpu_torch.ops.cuda.spearman_kernel import (
    spearman_cuda,
    spearman_plain,
)
from correrender_tpu_torch.ops.kendall import pair_counts
from correrender_tpu_torch.ops.special import digamma_series, select_kth

ATOL_RANK = 1e-6  # tests/test_pallas.py:142 (Kendall ties)
ATOL_SPEARMAN = 2e-6  # JAX's float32 rank sums against the exact int64 ones
ATOL_KSG = 8.58e-6  # BENCH_r05's KSG kernel-vs-XLA bar (ROADMAP "Recent")
ATOL_BANDED = 2e-4  # tests/test_pallas.py:199
ATOL_BANDED_NO_TIES = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rank_case(case):
    rng = np.random.default_rng(0)
    if case == "ties":  # tests/test_pallas.py:132-168
        stack = rng.integers(0, 20, size=(4, 6, 100)).astype(np.float32)
        ref = rng.integers(0, 20, size=100).astype(np.float32)
    else:  # unaligned n
        rng = np.random.default_rng(1)
        stack = rng.normal(size=(7, 73)).astype(np.float32)
        ref = rng.normal(size=73).astype(np.float32)
    return stack, ref


@pytest.mark.parametrize("case", ["ties", "unaligned"])
def test_spearman_plain_matches_pallas(case):
    stack, ref = rank_case(case)
    got = spearman_cuda(t(stack), t(ref))
    want = np.asarray(spearman_pallas(jnp.asarray(stack), jnp.asarray(ref),
                                      interpret=True))
    assert got.shape == stack.shape[:-1] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_SPEARMAN, rtol=0)


@pytest.mark.parametrize("case", ["ties", "unaligned"])
def test_kendall_plain_matches_pallas(case):
    stack, ref = rank_case(case)
    got = kendall_cuda(t(stack), t(ref))
    want = np.asarray(kendall_pallas(jnp.asarray(stack), jnp.asarray(ref),
                                     interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_RANK, rtol=0)


def test_spearman_nan_follows_the_xla_path():
    # A departure by design from the Pallas kernel, whose comparisons
    # rank a NaN member 0.5: the port ranks NaN last, as argsort does.
    from correrender_tpu import ops as jops

    rng = np.random.default_rng(3)
    stack = rng.normal(size=(3, 30)).astype(np.float32)
    ref = rng.normal(size=30).astype(np.float32)
    stack[1, [2, 9]] = np.nan
    got = spearman_plain(t(stack), t(ref)).numpy()
    xla = np.asarray(jops.spearman(jnp.asarray(ref), jnp.asarray(stack)))
    np.testing.assert_allclose(got, xla, atol=ATOL_SPEARMAN, rtol=0)
    pallas = np.asarray(spearman_pallas(jnp.asarray(stack), jnp.asarray(ref),
                                        interpret=True))
    assert abs(got[1] - pallas[1]) > 1e-3


def test_kendall_counts_are_exact_integers():
    # The pair sweep that B8's plain version runs, against a direct count.
    x = np.array([3, 1, 2, 2, 5], np.float32)
    y = np.array([[1, 1, 2, 3, 0]], np.float32)
    pairs = [(i, j) for i in range(5) for j in range(5)]
    sign = np.sign
    num = sum(int(sign(x[i] - x[j]) * sign(y[0, i] - y[0, j]))
              for i, j in pairs)
    tx = sum(x[i] == x[j] for i, j in pairs)
    ty = sum(y[0, i] == y[0, j] for i, j in pairs)
    txy = sum(y[0, i] == y[0, j] and x[i] == x[j] for i, j in pairs)
    for acc in (torch.int64, torch.float32):
        counts = [int(c.reshape(-1)[0])
                  for c in pair_counts(t(x), t(y), acc, chunk=2)]
        assert counts == [num, tx, ty, txy], acc


def test_kendall_plain_nan_and_limit():
    stack = np.random.default_rng(4).normal(size=(3, 20)).astype(np.float32)
    ref = stack[0].copy()
    stack[2, 4] = np.nan
    got = kendall_plain(t(stack), t(ref)).numpy()
    assert got[0] == pytest.approx(1.0) and np.isnan(got[2])
    ref[0] = np.nan
    assert np.isnan(kendall_plain(t(stack), t(ref)).numpy()).all()
    with pytest.raises(ValueError, match="46340"):
        kendall_plain(torch.zeros((0, 46341)), torch.zeros(46341))


# -- KSG ------------------------------------------------------------------


def small_stack():
    """tests/test_pallas.py's small_stack, cut to 24 voxels."""
    data = jfixtures.synth_box_ensemble(xs=8, ys=4, zs=2, members=100)
    stack = np.ascontiguousarray(np.moveaxis(data, 0, -1)[:, :, :3])
    return stack, stack[1, 2, 2].copy()


@pytest.mark.parametrize("estimator", [1, 2])
def test_ksg_plain_matches_pallas_with_noise(estimator):
    stack, ref = small_stack()
    got = mi_ksg_cuda(t(stack), t(ref), k=3, estimator=estimator)
    want = np.asarray(mi_ksg_pallas(jnp.asarray(stack), jnp.asarray(ref),
                                    k=3, estimator=estimator,
                                    interpret=True))
    assert got.shape == stack.shape[:-1]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_KSG, rtol=0)


@pytest.mark.parametrize("n", [100, 130])
def test_ksg_plain_matches_pallas_without_noise(n):
    rng = np.random.default_rng(1)  # tests/test_pallas.py:38-55
    x = rng.normal(size=n).astype(np.float32)
    ys = np.stack([0.8 * x + 0.2 * rng.normal(size=n).astype(np.float32),
                   rng.normal(size=n).astype(np.float32)])
    got = mi_ksg_plain(t(ys), t(x), k=3, use_noise=False)
    want = np.asarray(mi_ksg_pallas(jnp.asarray(ys), jnp.asarray(x), k=3,
                                    use_noise=False, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_KSG, rtol=0)


def banded_case(case):
    """The inputs of tests/test_pallas.py:183-298 (TestKsgBanded)."""
    if case == "matches_exact":
        rng = np.random.default_rng(0)
        n, v = 150, 20
        ref = rng.normal(size=n).astype(np.float32)
        series = rng.normal(size=(v, n)).astype(np.float32)
        series[:6] = ref[None, :] * 0.9 + 0.3 * series[:6]
        return series, ref, {}
    if case == "narrow_band":
        rng = np.random.default_rng(1)
        ref = rng.normal(size=120).astype(np.float32)
        series = rng.normal(size=(12, 120)).astype(np.float32)
        return series, ref, {"w_band": 16}
    if case == "ties_no_noise":
        rng = np.random.default_rng(2)
        ref = rng.integers(0, 6, size=100).astype(np.float32)
        series = rng.integers(0, 6, size=(8, 100)).astype(np.float32)
        return series, ref, {"use_noise": False}
    if case == "unaligned":
        rng = np.random.default_rng(3)
        ref = rng.normal(size=130).astype(np.float32)
        series = rng.normal(size=(13, 130)).astype(np.float32)
        return series, ref, {}
    # overflow: mass ties past the JAX kernel's 256-point repair tier
    return (np.zeros((4, 300), np.float32), np.zeros(300, np.float32),
            {"use_noise": False})


# Each case compiles its own JAX program (about 7 s here); estimator 2
# runs in the unaligned case.
BANDED_CASES = [("matches_exact", 1), ("narrow_band", 1),
                ("ties_no_noise", 1), ("unaligned", 2), ("overflow", 1)]


@pytest.mark.parametrize("case,estimator", BANDED_CASES)
def test_banded_plain_matches_pallas(case, estimator):
    series, ref, kw = banded_case(case)
    got = mi_ksg_banded(t(series), t(ref), k=3, estimator=estimator, **kw)
    want = np.asarray(jbanded(jnp.asarray(series), jnp.asarray(ref), k=3,
                              estimator=estimator, interpret=True, **kw))
    atol = ATOL_BANDED if case in ("ties_no_noise", "overflow") else (
        ATOL_BANDED_NO_TIES)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    # and the JAX package's XLA path, which both are held to
    xla = np.asarray(jksg(jnp.asarray(ref), jnp.asarray(series), k=3,
                          estimator=estimator,
                          use_noise=kw.get("use_noise", True)))
    np.testing.assert_allclose(got.numpy(), xla, atol=atol, rtol=0)


def test_banded_plain_is_the_full_row_answer():
    series, ref, _ = banded_case("matches_exact")
    for w in (16, 64, 192):
        assert torch.equal(mi_ksg_banded_plain(t(series), t(ref), w_band=w),
                           mi_ksg_plain(t(series), t(ref)))


def test_ksg_counts_match_a_direct_count():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, size=12).astype(np.float32)
    y = rng.integers(0, 4, size=(1, 12)).astype(np.float32)
    _, counts = mi_ksg_plain(t(y), t(x), k=2, use_noise=False,
                             with_counts=True)
    for i in range(12):
        d = np.maximum(np.abs(x - x[i]), np.abs(y[0] - y[0, i]))
        r = np.float32(np.sort(d)[2]) - np.float32(1e-6)
        cx = np.sum((x >= x[i] - r) & (x < x[i] + r))
        cy = np.sum((y[0] >= y[0, i] - r) & (y[0] < y[0, i] + r))
        assert counts[0, i].tolist() == [cx, cy], i


def test_ksg_nan_member_gives_nan():
    series, ref, _ = banded_case("unaligned")
    series[3, 10] = np.nan
    got = mi_ksg_banded(t(series), t(ref)).numpy()
    assert np.isnan(got[3]) and np.isfinite(np.delete(got, 3)).all()
    ref[0] = np.nan
    assert np.isnan(mi_ksg_cuda(t(series), t(ref)).numpy()).all()


def test_digamma_series_matches_jax():
    x = np.arange(1, 2000, dtype=np.float32)
    np.testing.assert_allclose(digamma_series(t(x)).numpy(),
                               np.asarray(digamma_vpu(jnp.asarray(x))),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(
        digamma_series(t(x)).double().numpy(),
        torch.special.digamma(t(x).double()).numpy(), atol=2e-6, rtol=0)


def test_select_kth_is_the_multiset_order_statistic():
    from correrender_tpu.ops.pallas.common import select_kth as jselect

    d = np.array([[3, 0, 1, 1, 1, 5], [0, 2, 2, 2, 9, 7]], np.float32)
    for k in range(4):
        np.testing.assert_array_equal(
            select_kth(t(d), k).numpy(),
            np.asarray(jselect(jnp.asarray(d), k, axis=1))[:, 0])


def test_band_width_and_ksg_args():
    assert band_width(1000, 3) == 192
    assert band_width(100, 3) == 128  # clamped to n rounded up to 128
    with pytest.raises(ValueError, match="band width"):
        band_width(100, 8, w_band=16)
    check_ksg_args(100, 15, 1, "cuda")
    with pytest.raises(ValueError, match="neighbours"):
        check_ksg_args(100, 16, 1, "cuda")
    check_ksg_args(100, 16, 1, "cpu")  # the plain versions take any k
    with pytest.raises(ValueError, match="estimator"):
        check_ksg_args(100, 3, 3, "cpu")
    with pytest.raises(ValueError, match="k=5"):
        check_ksg_args(5, 5, 1, "cpu")


WRAPPERS = [spearman_cuda, kendall_cuda, mi_ksg_cuda, mi_ksg_banded]


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("stack,ref,exc", [
    (torch.zeros((4, 8), dtype=torch.float64), torch.zeros(8), TypeError),
    (torch.zeros((4, 8)), torch.zeros(7), ValueError),
    (torch.zeros((4, 8), device="meta"), torch.zeros(8, device="meta"),
     ValueError),
])
def test_measure_wrappers_reject_bad_input(wrapper, stack, ref, exc):
    with pytest.raises(exc):
        wrapper(stack, ref)


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_cpu_measure_wrappers_never_count_a_launch(wrapper):
    series, ref, _ = banded_case("unaligned")
    _build.reset_launch_counts()
    out = wrapper(t(series[:3]), t(ref))
    assert out.shape == (3,) and not any(_build.LAUNCHES.values())


def test_wrappers_return_counts_on_the_cpu():
    series, ref, _ = banded_case("unaligned")
    mi, counts = mi_ksg_cuda(t(series[:2]), t(ref), with_counts=True)
    mi10, info = mi_ksg_banded(t(series[:2]), t(ref), with_counts=True)
    assert counts.shape == (2, 130, 2) and torch.equal(info["counts"], counts)
    assert torch.equal(mi, mi10)
