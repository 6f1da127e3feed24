"""PyTorch port (correrender_tpu_torch): numpy models of the counting
schemes of kernels B8 (Kendall, Knight's merge count) and B10 (KSG, the
pruned scan in x order), held on the CPU to the plain versions and to
the JAX package, and the host helpers of both wrappers.

The CUDA kernels run only on the card, where chip_smoke.py holds them to
their plain versions (B8 exactly, B10 count for count against B9). These
tests hold the schemes the kernels run, step for step, to the answers
those plain versions give.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from correrender_tpu import ops as jops

from correrender_tpu_torch.ops.cuda.kendall_kernel import (
    _tie_pairs,
    reference_order,
)
from correrender_tpu_torch.ops.kendall import pair_counts, tau_from_counts
from correrender_tpu_torch.ops.ranks import run_bounds, stable_order

ATOL_KENDALL_JAX = 1e-6  # tests/test_pallas.py:142 (Kendall ties)
COUNT_EPSILON = np.float32(1e-6)  # the TPU kernel's gap-check margin


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- B8: Knight's merge count, as csrc/kendall.cu runs it ------------------


def run_rank(a, g, lo, hi, key, key_g, strict):
    """#{j ∈ [lo, hi) : (g_j, a_j) < (key_g, key)} (strict) or ≤, by the
    kernel's binary search; g None compares the values alone."""
    base = lo
    while lo < hi:
        mid = (lo + hi) // 2
        before = a[mid] < key if strict else a[mid] <= key
        if g is not None:
            before = g[mid] < key_g or (g[mid] == key_g and before)
        if before:
            lo = mid + 1
        else:
            hi = mid
    return lo - base


def merge_sort(buf, g):
    """The kernel's bottom-up merge sort: each element placed by one
    binary search in its partner run; returns (sorted, exchanges), the
    exchanges being, per right-run element, the left-run elements
    strictly greater."""
    n = len(buf)
    exchanges, w = 0, 1
    while w < n:
        out = np.empty_like(buf)
        for q in range(n):
            s = q & ~(2 * w - 1)
            mid, e = min(s + w, n), min(s + 2 * w, n)
            key, kg = buf[q], (g[q] if g is not None else 0)
            if q < mid:
                dst = q + run_rank(buf, g, mid, e, key, kg, True)
            else:
                le = run_rank(buf, g, s, mid, key, kg, False)
                dst = q - (mid - s) + le
                exchanges += (mid - s) - le
            out[dst] = key
        buf, w = out, 2 * w
    return buf, exchanges


def tied_pairs(a, g):
    """Σ_q (q − first index of q's run of equal values in a[lo(q)..q])."""
    total = 0
    for q in range(len(a)):
        lo = int(g[q]) if g is not None else 0
        total += (q - lo) - run_rank(a, None, lo, q, a[q], 0, True)
    return total


def knight_counts(x, y):
    """B8's four ordered-pair counts (num, x ties, y ties, joint ties) of
    one voxel by the kernel's scheme; the x ties are the host's."""
    n = len(x)
    perm, gstart = (p.numpy() for p in reference_order(t(x)))
    buf = y[perm]
    n1 = n3 = 0
    if (gstart != np.arange(n)).any():
        buf, _ = merge_sort(buf, gstart)
        n3 = tied_pairs(buf, gstart)
        n1 = int((np.arange(n) - gstart).sum())
    buf, s = merge_sort(buf, None)
    n2 = tied_pairs(buf, None)
    n0 = n * (n - 1) // 2
    return (2 * (n0 - n1 - n2 + n3 - 2 * s), 2 * n1 + n, 2 * n2 + n,
            2 * n3 + n)


def kendall_case(case, n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    y = (0.6 * x + rng.normal(size=n)).astype(np.float32)
    if case in ("x_ties", "joint_ties"):
        x = np.round(x * 2.0).astype(np.float32)
    if case in ("y_ties", "joint_ties"):
        y = np.round(y).astype(np.float32)
    if case == "joint_ties":
        y[: n // 3] = x[: n // 3]
    if case == "signed_zeros":  # −0 == +0, as the pair sweep's signs
        x = np.round(x).astype(np.float32) * np.float32(0.0)
        x[::2] = -x[::2]
        y = np.where(rng.random(n) < 0.5, np.float32(-0.0), y)
    if case == "constant":
        y = np.full(n, 3.0, np.float32)
    return x, y.astype(np.float32)


KENDALL_CASES = ["continuous", "x_ties", "y_ties", "joint_ties",
                 "signed_zeros", "constant"]


@pytest.mark.parametrize("n", [1, 2, 3, 33, 100, 257])
@pytest.mark.parametrize("case", KENDALL_CASES)
def test_knight_counts_equal_the_pair_sweep(case, n):
    x, y = kendall_case(case, n)
    want = [int(c) for c in pair_counts(t(x), t(y), torch.int64)]
    assert list(knight_counts(x, y)) == want


@pytest.mark.parametrize("case", KENDALL_CASES)
def test_knight_tau_matches_jax(case):
    x, y = kendall_case(case, 100)
    num, tx, ty, txy = (torch.tensor(c) for c in knight_counts(x, y))
    tau = tau_from_counts(100, num, tx, ty, txy)
    want = np.asarray(jops.kendall(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(tau.numpy(), want, atol=ATOL_KENDALL_JAX,
                               rtol=0)
    assert int(tx) == int(_tie_pairs(t(x)))  # the host's x ties


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(-3, 3), st.integers(-3, 3)),
                min_size=1, max_size=40))
def test_knight_counts_on_small_integer_grids(points):
    xy = np.asarray(points, np.float32)
    x, y = xy[:, 0].copy(), xy[:, 1].copy()
    want = [int(c) for c in pair_counts(t(x), t(y), torch.int64)]
    assert list(knight_counts(x, y)) == want


# -- B10: the pruned scan, as csrc/ksg_banded.cu runs it -------------------

F32_INF = np.float32(np.inf)


class KSmallest:
    """The kernel's register list: the kp1 smallest values pushed."""

    def __init__(self, kp1):
        self.vals = [F32_INF] * kp1

    @property
    def top(self):
        return max(self.vals)

    def push(self, d):
        if d < self.top:
            self.vals[self.vals.index(self.top)] = d


def x_gap(xs, j, xi):
    return abs(xs[j] - xi) if 0 <= j < len(xs) else F32_INF


WALK_WIDTH = 8  # csrc/ksg_banded.cu: kWalkWidth


def walk_kth(xs, ys, i, kp1):
    """Point i's k-th distance by the walk, WALK_WIDTH points down and
    WALK_WIDTH up per round (a point past either end at +inf), a side
    stopped once the last |Δx| it read is ≥ top[0]; with the first
    points not visited on either side."""
    n, xi, yi = len(xs), xs[i], ys[i]
    best = KSmallest(kp1)
    best.push(max(abs(xs[i] - xi), abs(ys[i] - yi)))
    ends, going = [i - 1, i + 1], [True, True]
    while any(going):
        for side, step in ((0, -1), (1, 1)):
            if going[side]:
                dx = F32_INF
                for u in range(WALK_WIDTH):
                    j = ends[side] + u * step
                    dx = x_gap(xs, j, xi)
                    if 0 <= j < n:
                        best.push(max(dx, abs(ys[j] - yi)))
                ends[side] += WALK_WIDTH * step
                going[side] = dx < best.top
    return best.top, max(ends[0], -1), min(ends[1], n)


def walk_extents(xs, ys, i, r, lo, hi):
    """Estimator 2's extents: the visited range again with r, then on
    while |Δx| ≤ r until both extents reach r; with the new lo, hi."""
    xi, yi = xs[i], ys[i]
    mx = my = np.float32(-1.0)
    for j in range(lo + 1, hi):
        dx, dy = abs(xs[j] - xi), abs(ys[j] - yi)
        if max(dx, dy) <= r:
            mx, my = max(mx, dx), max(my, dy)
    ends = []
    for step, j in ((-1, lo), (1, hi)):
        while not (mx == r and my == r):
            dx = x_gap(xs, j, xi)
            if not dx <= r:
                break
            dy = abs(ys[j] - yi)
            if max(dx, dy) <= r:
                mx, my = max(mx, dx), max(my, dy)
            j += step
        ends.append(j)
    return mx, my, ends[0], ends[1]


def full_row(xs, ys, i, kp1):
    """B9's answer: the (k+1)-th smallest of the whole row and the
    extents of {j : dch_j ≤ r}."""
    dx, dy = np.abs(xs - xs[i]), np.abs(ys - ys[i])
    d = np.maximum(dx, dy)
    r = np.sort(d)[kp1 - 1]
    inside = d <= r
    return r, dx[inside].max(), dy[inside].max()


def ksg_case(case, n=100):
    rng = np.random.default_rng(7)
    x = rng.normal(size=n).astype(np.float32)
    y = (0.7 * x + 0.7 * rng.normal(size=n)).astype(np.float32)
    if case == "quantized":  # ties broken by the wrapper's 1e-5 noise
        u = rng.random((2, n)).astype(np.float32) * np.float32(1e-5)
        x = np.round(x * 2.0).astype(np.float32) + u[0]
        y = np.round(y * 2.0).astype(np.float32) + u[1]
    if case == "mass_ties":  # three levels, no noise: r = 0 for many
        x = np.clip(np.round(x), -1, 1).astype(np.float32)
        y = np.clip(np.round(y), -1, 1).astype(np.float32)
    if case == "anti_correlated":
        y = (-x + np.float32(0.05) * rng.normal(size=n)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("k", [1, 3, 7, 15])
@pytest.mark.parametrize("case", ["continuous", "quantized", "mass_ties",
                                  "anti_correlated"])
def test_pruned_scan_gives_the_full_row_bit_for_bit(case, k):
    x, y = ksg_case(case)
    perm, xs = (a.numpy() for a in stable_order(t(x)))
    ys = y[perm]
    n, visited = len(x), 0
    for i in range(n):
        r, lo, hi = walk_kth(xs, ys, i, k + 1)
        r_full, ex_full, ey_full = full_row(xs, ys, i, k + 1)
        assert r == r_full, (i, r, r_full)
        mx, my, lo2, hi2 = walk_extents(xs, ys, i, r, lo, hi)
        assert (mx, my) == (ex_full, ey_full), i
        assert lo2 <= lo and hi2 >= hi
        if r == 0:  # mass ties: the extents walk reads nothing more
            assert (lo2, hi2) == (lo, hi)
        visited += hi2 - lo2 - 1
    if case == "continuous" and k == 3:  # the slab, not the row
        assert visited < 0.4 * n * n, visited


def out_of_band(xs, i, r, half_band, estimator):
    """csrc/ksg_banded.cu's `repaired` test: the first point past each
    edge of the band [i − half_band, i + half_band) decides."""
    gap = min(x_gap(xs, i - half_band - 1, xs[i]),
              x_gap(xs, i + half_band, xs[i]))
    return gap <= r if estimator == 2 else gap < r


@pytest.mark.parametrize("half_band", [8, 64])
@pytest.mark.parametrize("estimator", [1, 2])
@pytest.mark.parametrize("case", ["continuous", "quantized", "mass_ties",
                                  "anti_correlated"])
def test_repaired_counts_the_points_that_need_one_outside_the_band(
        case, estimator, half_band):
    # A point counts when its answer needs a point outside its rank band:
    # one with |Δx| < r (estimator 2's extents: ≤ r). The points the walk
    # reads past its stop do not count.
    x, y = ksg_case(case)
    perm, xs = (a.numpy() for a in stable_order(t(x)))
    ys = y[perm]
    n = len(x)
    idx = np.arange(n)
    counted = 0
    for i in range(n):
        r, lo, hi = walk_kth(xs, ys, i, 4)
        dx = np.abs(xs - xs[i])
        need = dx <= r if estimator == 2 else dx < r
        outside = (idx < i - half_band) | (idx >= i + half_band)
        want = bool((need & outside).any())
        assert out_of_band(xs, i, r, half_band, estimator) == want, i
        # the walk reads every point with |Δx| < r
        assert not (dx < r)[(idx <= lo) | (idx >= hi)].any(), i
        # the TPU kernel's gap check repairs at least these points
        edge_gap = min(x_gap(xs, i - half_band - 1, xs[i]),
                       x_gap(xs, i + half_band, xs[i]))
        assert not want or edge_gap <= np.float32(r + COUNT_EPSILON), i
        counted += want
    if half_band == 8 and case in ("continuous", "quantized"):
        assert 0 < counted < n, counted
    if half_band == 64 and case == "continuous":
        assert counted < n // 4, counted


# -- the wrappers' host helpers ---------------------------------------------


def test_reference_order_groups_ties():
    x = np.array([2.0, -0.0, 1.0, 0.0, np.nan, 2.0, 1.0, np.nan, 2.0],
                 np.float32)
    perm, gstart = reference_order(t(x))
    assert perm.dtype == torch.int32 and gstart.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(x, kind="stable"))
    # sorted: −0, 0, 1, 1, 2, 2, 2, NaN, NaN; each NaN its own group
    np.testing.assert_array_equal(gstart.numpy(),
                                  [0, 0, 2, 2, 4, 4, 4, 7, 8])


@pytest.mark.parametrize("n", [1, 2, 37, 250])
def test_reference_order_matches_a_direct_count(n):
    x = np.random.default_rng(n).integers(0, 5, size=n).astype(np.float32)
    perm, gstart = (a.numpy() for a in reference_order(t(x)))
    xs = x[perm]
    assert (np.diff(xs) >= 0).all()
    for q in range(n):
        first = q
        while first > 0 and xs[first - 1] == xs[q]:
            first -= 1
        assert gstart[q] == first
    # the x ties as the kernel reads them off gstart and as the host
    # counts them, against a direct count over ordered pairs
    ties = int((x[:, None] == x[None, :]).sum())
    assert 2 * int((np.arange(n) - gstart).sum()) + n == ties
    assert int(_tie_pairs(t(x))) == ties


def test_stable_order_is_the_wrappers_x_order():
    x = np.random.default_rng(2).normal(size=130).astype(np.float32)
    x[[5, 40]] = x[7]
    perm, xs = stable_order(t(x))
    assert perm.dtype == torch.int32 and xs.dtype == torch.float32
    np.testing.assert_array_equal(perm.numpy(), np.argsort(x, kind="stable"))
    assert torch.equal(xs, t(x)[perm.long()])


def test_run_bounds_along_the_last_axis():
    v = torch.tensor([[1.0, 1.0, 2.0, 3.0, 3.0, 3.0],
                      [0.0, 1.0, 2.0, 2.0, 4.0, 5.0]])
    first, last = run_bounds(v)
    assert first.tolist() == [[0, 0, 2, 3, 3, 3], [0, 1, 2, 2, 4, 5]]
    assert last.tolist() == [[1, 1, 2, 5, 5, 5], [0, 1, 3, 3, 4, 5]]


@pytest.mark.parametrize("n", [1, 2, 37, 250])
def test_run_bounds_match_a_direct_scan(n):
    # -0.0 == 0.0, and each NaN is a run of its own (NaN sorts last).
    rng = np.random.default_rng(n)
    x = rng.integers(-2, 3, size=n).astype(np.float32) * np.float32(0.5)
    x[rng.random(n) < 0.2] = np.float32(-0.0)
    x[rng.random(n) < 0.1] = np.nan
    xs = np.sort(x, kind="stable")
    first, last = (a.numpy() for a in run_bounds(t(xs)))
    for q in range(n):
        lo = hi = q
        while lo > 0 and xs[lo - 1] == xs[q]:
            lo -= 1
        while hi < n - 1 and xs[hi + 1] == xs[q]:
            hi += 1
        assert (first[q], last[q]) == (lo, hi), q
