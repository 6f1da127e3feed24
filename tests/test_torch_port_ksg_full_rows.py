"""PyTorch port (correrender_tpu_torch): kernel B9 (``csrc/ksg.cu``, KSG
over the full Chebyshev rows) on the CPU.

- The kernel's count rule, two binary searches in a sorted copy,
  against ``ops/mi_ksg.py::_range_count``, the plain version's scan, on
  duplicates, mass ties, ±0.0, radii equal to an exact gap, negative
  radii and subnormals.
- A numpy model of the kernel's steps (the row-tiled k-th-distance pass
  in its outward scan order with vote-guarded pushes, estimator 2's
  walk over the lane's rows' rank windows, the searches), held point
  for point to the plain version's counts; the scan's reads on distinct
  banks.
- The plain version against the JAX package's Pallas kernel in
  interpret mode on ``chip_smoke.py::measure_inputs``' quantized and
  tied series at n = 37 and 250.
- The KSG kernels' member limit on a CUDA device.

The CUDA kernel runs only on the card, where chip_smoke.py holds it to
the plain version (counts equal, MI within 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu.ops.pallas import mi_ksg_pallas

from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda.ksg_kernel import (
    check_ksg_args,
    mi_ksg_plain,
)
from correrender_tpu_torch.ops.mi_ksg import _range_count, ksg_psi_sums
from correrender_tpu_torch.ops.noise import COUNT_EPSILON
from correrender_tpu_torch.ops.ranks import stable_order
from correrender_tpu_torch.ops.special import digamma_series

ATOL_KSG = 1e-5  # chip_smoke.py's ATOL_KSG (tests/test_pallas.py:68)
F32 = np.float32
INF = F32(np.inf)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def search_counts(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The kernel's count rule: #(sorted < v + r) − #(sorted < v − r),
    each bound rounded once, clamped at 0 as the kernel clamps it (a
    negative radius turns the difference negative)."""
    s = torch.sort(v).values
    hi = torch.searchsorted(s, v + r, side="left")
    lo = torch.searchsorted(s, v - r, side="left")
    return (hi - lo).clamp(min=0)


def count_case(case):
    rng = np.random.default_rng(11)
    if case == "duplicates":
        v = rng.integers(0, 9, size=60).astype(F32) * F32(0.25)
        r = rng.choice([0.0, 0.25, 0.5, 1.0, 0.3], size=60).astype(F32)
    elif case == "mass_ties":  # three levels; r = d_k − ε as estimator 1
        v = np.clip(np.round(rng.normal(size=80)), -1, 1).astype(F32)
        r = (rng.choice([0.0, 1.0, 2.0], size=80).astype(F32)
             - F32(COUNT_EPSILON))
    elif case == "signed_zeros":
        v = rng.choice([-0.0, 0.0, 1e-7, -1e-7, 1.0], size=50).astype(F32)
        r = rng.choice([0.0, 1e-7, 2e-7, 1.0], size=50).astype(F32)
    elif case == "exact_gaps":  # v ± r lands on another value exactly
        v = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 2.0, 3.0, 0.75], F32)
        r = np.array([0.5, 0.5, 1.0, 0.5, 1.0, 0.0, 1.0, 0.25], F32)
    elif case == "negative_radius":  # r = 0 − ε: the count is 0
        v = rng.integers(0, 3, size=40).astype(F32)
        r = np.full(40, -COUNT_EPSILON, F32)
        r[::3] = F32(-1.5)
    else:  # subnormals
        tiny = np.finfo(F32).smallest_subnormal
        v = (rng.integers(-4, 5, size=50) * tiny).astype(F32)
        r = (rng.integers(-1, 4, size=50) * tiny).astype(F32)
    return t(v), t(r)


COUNT_CASES = ["duplicates", "mass_ties", "signed_zeros", "exact_gaps",
               "negative_radius", "subnormals"]


@pytest.mark.parametrize("case", COUNT_CASES)
def test_search_counts_equal_the_scan(case):
    v, r = count_case(case)
    got = search_counts(v, r)
    want = _range_count(v, r)
    assert torch.equal(got, want), (got, want)
    if case == "negative_radius":
        assert not bool(want.any())
    if case == "exact_gaps":  # [v − r, v + r) takes the low end only
        assert want.tolist() == [1, 3, 5, 2, 4, 0, 3, 2]


def test_zero_radius_counts_nothing_and_clamps_psi():
    # Mass ties without noise under estimator 1: the (k+1)-th distance
    # is 0, the radius 0 − ε, every count 0 and every ψ term ψ(1).
    x = torch.ones(20)
    y = torch.zeros((1, 20))
    psi, counts = ksg_psi_sums(x, y, 3, 1, with_counts=True)
    assert not bool(counts.any())
    want = 2 * 20 * float(digamma_series(torch.tensor(1.0)))
    assert float(psi[0]) == pytest.approx(want, rel=1e-6)


# -- a numpy model of the kernel's steps -------------------------------------

WARP = 32


def rows_a_lane(k: int) -> int:
    """csrc/ksg.cu: kRows, 8 rows a lane up to k + 1 = 4, 4 up to 8,
    else 2."""
    kmax = 4 if k + 1 <= 4 else 8 if k + 1 <= 8 else 16
    return WARP // kmax


def lane_firsts(base: int, rows: int):
    """The first of each lane's rows: a lane takes `rows` consecutive
    points in x order, lanes `rows` apart."""
    return base + rows * np.arange(WARP)


def swizzled(j, rows: int):
    """ksg_common.cuh::swizzled<R>: where index j sits in the arrays."""
    return j ^ ((j >> 5) & (rows - 1))


def scan_order(n: int, first, rows: int):
    """The points a lane reads in the k-th-distance pass, in order: up,
    down, up, ... from the middle of its rows, indices mod n."""
    up = np.minimum(first + (rows - 1) // 2, n - 1)
    down = np.where(up == 0, n - 1, up - 1)
    order = []
    for _ in range(n // 2):
        order += [up, down]
        up = np.where(up + 1 == n, 0, up + 1)
        down = np.where(down == 0, n - 1, down - 1)
    if n & 1:
        order.append(up)
    return np.stack(order)


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [2, 3, 5, 31, 37, 250, 256, 1000, 1029])
def test_scan_reads_every_point_once_on_distinct_banks(n, rows):
    padded = -(-n // 8) * 8
    assert sorted(swizzled(np.arange(padded), rows)) == list(range(padded))
    for base in range(0, n, WARP * rows):
        firsts = lane_firsts(base, rows)
        order = scan_order(n, firsts, rows)  # (n, lanes)
        assert order.shape == (n, WARP)
        assert (np.sort(order, axis=0) == np.arange(n)[:, None]).all()
        if (firsts + rows < n).all():  # no lane clamped to the last point
            # the lanes' reads, `rows` apart mod n, on 32 distinct banks
            # (a step that wraps past n may repeat one bank)
            banks = swizzled(order, rows) % 32
            distinct = np.array([len(set(b)) for b in banks])
            wraps = (order < order[:, :1]).any(axis=1)
            assert (distinct[~wraps] == WARP).all()


def vote_guarded_push(top, d):
    """One step's pushes into each (lane, row)'s list of the kp1
    smallest: a value below its list's largest replaces it (a push equal
    to it changes nothing)."""
    largest = top.max(-1)
    beat = d < largest
    lane, row = np.nonzero(beat)
    top[lane, row, top[lane, row].argmax(-1)] = d[lane, row]


def kth_pass(xs, ys, base, k):
    """r of the rows of each lane of the tile at base, by the kernel's
    scan."""
    n, rows = len(xs), rows_a_lane(k)
    i = lane_firsts(base, rows)[:, None] + np.arange(rows)[None, :]
    live = i < n
    xr = np.where(live, xs[np.minimum(i, n - 1)], INF)
    yr = np.where(live, ys[np.minimum(i, n - 1)], INF)
    top = np.full((WARP, rows, k + 1), INF, F32)

    def dist(j):
        return np.maximum(np.abs(xs[j][:, None] - xr),
                          np.abs(ys[j][:, None] - yr))

    order = scan_order(n, lane_firsts(base, rows), rows)
    for m in range(0, n - 1, 2):
        du, dd = dist(order[m]), dist(order[m + 1])
        largest = top.max(-1)
        if ((du < largest) | (dd < largest)).any():  # the warp vote
            vote_guarded_push(top, du)
            vote_guarded_push(top, dd)
    if n & 1:
        vote_guarded_push(top, dist(order[-1]))
    return i, live, top.max(-1)


def lane_extents(xs, ys, rows, live, r):
    """Estimator 2's extents of one lane's consecutive rows (Rows::extents):
    the rows' span once, then a walk down and a walk up until |Δx| passes
    every live row's r, each candidate read once for all rows."""
    n = len(xs)
    rr = np.where(live, r, F32(-1.0))
    ex = np.full(len(rows), F32(-1.0))
    ey = np.full(len(rows), F32(-1.0))
    ii = np.minimum(rows, n - 1)
    xr, yr = np.where(live, xs[ii], INF), np.where(live, ys[ii], INF)

    def extend(j):
        dx, dy = np.abs(xs[j] - xr), np.abs(ys[j] - yr)
        joins = np.maximum(dx, dy) <= rr
        ex[joins] = np.maximum(ex[joins], dx[joins])
        ey[joins] = np.maximum(ey[joins], dy[joins])
        return bool((dx <= rr).any())

    lo, hi = min(rows[0], n), min(rows[-1] + 1, n)
    for j in range(lo, hi):
        extend(j)
    j = lo - 1
    while j >= 0 and extend(j):
        j -= 1
    j = hi
    while j < n and extend(j):
        j += 1
    return ex, ey


def b9_model(x, y, k, estimator):
    """The kernel's steps on one voxel (noised x and y): per-point
    counts in the series' order, and each row's k-th distance."""
    n = len(x)
    perm, xs = (a.numpy() for a in stable_order(t(x)))
    ys = y[perm]
    ysorted = np.sort(y)
    counts = np.zeros((n, 2), np.int32)
    r_of = np.zeros(n, F32)
    for base in range(0, n, WARP * rows_a_lane(k)):
        idx, live, r = kth_pass(xs, ys, base, k)
        ext = [lane_extents(xs, ys, idx[lane], live[lane], r[lane])
               for lane in range(WARP)] if estimator == 2 else None
        for lane, row in zip(*np.nonzero(live)):
            i, ri = idx[lane, row], r[lane, row]
            r_of[i] = ri
            if estimator == 1:
                rx = ry = F32(ri - F32(COUNT_EPSILON))
            else:
                ex, ey = ext[lane][0][row], ext[lane][1][row]
                rx, ry = F32(ex + F32(COUNT_EPSILON)), F32(ey + F32(
                    COUNT_EPSILON))
            cx = (np.searchsorted(xs, F32(xs[i] + rx), "left")
                  - np.searchsorted(xs, F32(xs[i] - rx), "left"))
            cy = (np.searchsorted(ysorted, F32(ys[i] + ry), "left")
                  - np.searchsorted(ysorted, F32(ys[i] - ry), "left"))
            counts[perm[i]] = max(cx, 0), max(cy, 0)
    return counts, r_of, xs, ys


def model_case(case, n):
    rng = np.random.default_rng(13)
    x = rng.normal(size=n).astype(F32)
    y = (0.6 * x + 0.8 * rng.normal(size=n)).astype(F32)
    if case == "quantized":  # ties broken by 1e-5 noise, as the wrapper
        u = rng.random((2, n)).astype(F32) * F32(1e-5)
        x = (np.round(x * 2) / 2).astype(F32) + u[0]
        y = (np.round(y * 2) / 2).astype(F32) + u[1]
    elif case == "mass_ties":  # three levels, no noise: r = 0 for many
        x = np.clip(np.round(x), -1, 1).astype(F32)
        y = np.clip(np.round(y), -1, 1).astype(F32)
    elif case == "signed_zeros":
        x = (np.round(x) * 0.0).astype(F32)
        x[rng.random(n) < 0.5] *= -1
        y = np.round(y * 4).astype(F32)
    return x, y


@pytest.mark.parametrize("estimator", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7, 15])
@pytest.mark.parametrize("case,n", [("continuous", 37), ("quantized", 250),
                                    ("mass_ties", 250),
                                    ("signed_zeros", 100)])
def test_kernel_model_counts_equal_the_plain_version(case, n, k, estimator):
    x, y = model_case(case, n)
    counts, r, xs, ys = b9_model(x, y, k, estimator)
    d = np.maximum(np.abs(xs[:, None] - xs[None, :]),
                   np.abs(ys[:, None] - ys[None, :]))
    np.testing.assert_array_equal(r, np.sort(d, axis=1)[:, k])
    _, want = mi_ksg_plain(t(y[None]), t(x), k=k, estimator=estimator,
                           use_noise=False, with_counts=True)
    np.testing.assert_array_equal(counts, want[0].numpy())


# -- the plain version against the JAX package -------------------------------


def measure_inputs(n: int):
    """chip_smoke.py::measure_inputs in numpy: (96, n) series with
    correlated voxels, quantized ties, a repeated member, a NaN voxel
    and a constant voxel; the continuous and the quantized reference."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=n).astype(F32)
    y = rng.normal(size=(96, n)).astype(F32)
    y[:16] = 0.8 * x + 0.6 * y[:16]
    y[16:40] = np.round(y[16:40] * 2.0) / 2.0
    y[40:48, min(5, n - 1)] = y[40:48, min(3, n - 1)]
    y[48, n // 2] = np.nan
    y[49] = 1.0
    return y, {"continuous": x, "quantized": np.round(x * 2.0) / 2.0}


@pytest.mark.parametrize("estimator", [1, 2])
@pytest.mark.parametrize("ref", ["continuous", "quantized"])
@pytest.mark.parametrize("n", [37, 250])
def test_plain_matches_pallas_on_the_measure_inputs(n, ref, estimator):
    y, refs = measure_inputs(n)
    x = refs[ref].astype(F32)
    got = mi_ksg_plain(t(y), t(x), k=3, estimator=estimator).numpy()
    want = np.asarray(mi_ksg_pallas(jnp.asarray(y), jnp.asarray(x), k=3,
                                    estimator=estimator, interpret=True))
    assert np.isnan(got[48])  # the NaN voxel (JAX's paths differ there)
    keep = np.arange(96) != 48
    np.testing.assert_allclose(got[keep], want[keep], atol=ATOL_KSG, rtol=0)


# -- the member limit ---------------------------------------------------------


@pytest.mark.parametrize("estimator", [1, 2])
def test_member_limit_on_a_cuda_device(estimator):
    # Decided from the device string alone: no card is needed.
    n = _build.MAX_MEMBERS
    assert n == 12288
    for device in ("cuda", "cuda:0", torch.device("cuda", 0)):
        check_ksg_args(n, 3, estimator, device)
        check_ksg_args(n, 15, estimator, device)
        with pytest.raises(ValueError, match="12288"):
            check_ksg_args(n + 1, 3, estimator, device)
    check_ksg_args(n + 1, 3, estimator, "cpu")  # the plain version
