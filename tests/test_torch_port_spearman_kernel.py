"""PyTorch port (correrender_tpu_torch): a numpy model of kernel B7's
scheme (``csrc/spearman.cu``), held on the CPU to the plain version's
doubled ranks and to the JAX package.

The model runs the kernel's steps: the 32-bit sort keys (−0 made +0, a
NaN member j at 0xFF800001 + j, padding at 0xFFFFFFFE), the striped
load into the lanes' slots, with the doubled reference rank as the only
payload; on the register path each lane's odd-even merge sort of its
slots,
then the merges of runs E, 2E, ... wide, each lane finding its diagonal
by merge path over runs that end in a 0xFFFFFFFF slot and merging its E
outputs serially; on the shared path one bitonic network; the run
bounds read off the sorted keys (lane-local masks, then carries across
the lane group; the shared path's 32-wide chunks), and the integer
moments with Σ2r = n(n + 1) written instead of summed. The model also
carries each member's index beside the payload (the kernel does not) to
compare its ranks member by member. The kernel itself runs only on the card, where
chip_smoke.py holds it to its plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu import ops as jops

from correrender_tpu_torch.ops.cuda.spearman_kernel import spearman_plain
from correrender_tpu_torch.ops.spearman import (
    doubled_ranks,
    rho_from_moments,
)

PAD_KEY = np.uint32(0xFFFFFFFE)
RUN_END = np.uint32(0xFFFFFFFF)
NAN_KEY = 0xFF800001
NARROW_MAX_MEMBERS = 128  # ksg_common.cuh: kNarrowMaxMembers
REGISTER_MAX_MEMBERS = 1024  # spearman.cu: kRegisterMaxMembers
INT_MAX = 2**31 - 1
ATOL_SPEARMAN_JAX = 1e-6  # JAX sums the ranks in float32


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def sort_keys(y):
    """The kernel's keys of an ``(n,)`` float32 series."""
    c = (y + np.float32(0.0)).astype(np.float32)  # −0 + 0 = +0
    u = c.view(np.uint32)
    keys = np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint32)
    nan = np.isnan(c)
    keys[nan] = (NAN_KEY + np.flatnonzero(nan)).astype(np.uint32)
    return keys


def pow2_at_least(n, floor):
    p = floor
    while p < n:
        p *= 2
    return p


def bitonic(keys, *payloads):
    """The shared path's network over the positions, in place: pairs
    (p, p ^ j), ascending where p & size is 0; equal keys stay."""
    n = len(keys)
    pos = np.arange(n)
    size = 2
    while size <= n:
        j = size // 2
        while j > 0:
            lo = pos[(pos ^ j) > pos]
            hi = lo ^ j
            a, b = keys[lo], keys[hi]
            swap = np.where((lo & size) != 0, a < b, a > b)
            for arr in (keys, *payloads):
                x, y = arr[lo].copy(), arr[hi].copy()
                arr[lo] = np.where(swap, y, x)
                arr[hi] = np.where(swap, x, y)
            j //= 2
        size *= 2


def odd_even_pairs(n):
    """Batcher's odd-even merge sort network on n (a power of two)
    slots, as the kernel's odd_even_sort unrolls it."""
    pairs, p = [], 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def merge_levels(keys, lanes, *payloads):
    """The register path's order, in place: each lane's E slots sorted
    by the odd-even merge network, then runs merged pairwise. Lane l of a merged
    run finds its diagonal d = l·E mod 2w by merge path (A first on equal
    keys) and merges E outputs serially, reading past neither run: each
    ends in a RUN_END slot."""
    e_count = len(keys) // lanes
    arrays = (keys, *payloads)
    for sub in range(lanes):
        base = sub * e_count
        for a, b in odd_even_pairs(e_count):
            if keys[base + a] > keys[base + b]:
                for arr in arrays:
                    arr[base + a], arr[base + b] = arr[base + b], arr[base + a]
    w = e_count
    while w < len(keys):
        out = [arr.copy() for arr in arrays]
        for sub in range(lanes):
            base = sub * e_count
            run0 = base - base % (2 * w)
            d = base - run0
            a = [np.append(arr[run0:run0 + w], RUN_END if i == 0 else 0)
                 for i, arr in enumerate(arrays)]
            b = [np.append(arr[run0 + w:run0 + 2 * w], RUN_END if i == 0
                           else 0) for i, arr in enumerate(arrays)]
            lo, hi = max(0, d - w), min(d, w)
            while lo < hi:
                mid = (lo + hi) // 2
                if a[0][mid] <= b[0][d - 1 - mid]:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, d - lo
            for e in range(e_count):
                take_a = a[0][i] <= b[0][j]
                for arr, av, bv in zip(out, a, b):
                    arr[base + e] = av[i] if take_a else bv[j]
                i, j = i + take_a, j + (not take_a)
        for arr, new in zip(arrays, out):
            arr[:] = new
        w *= 2


def register_path(keys, lanes):
    """2r at each sorted position of the register path: run masks per
    lane, then the carries across the lane group."""
    e_count = len(keys) // lanes
    k = keys.reshape(lanes, e_count)  # lane sub: positions sub·E + e
    flat_prev = np.concatenate([[PAD_KEY], keys[:-1]])
    flat_next = np.concatenate([keys[1:], [PAD_KEY]])
    pos = np.arange(len(keys)).reshape(lanes, e_count)
    starts = (pos == 0) | (k != flat_prev.reshape(k.shape))
    ends = (pos == len(keys) - 1) | (k != flat_next.reshape(k.shape))
    lane_start = np.where(starts.any(1),
                          np.where(starts, pos, -1).max(1), -1)
    lane_end = np.where(ends.any(1),
                        np.where(ends, pos, INT_MAX).min(1), INT_MAX)
    r2 = np.empty_like(pos)
    for sub in range(lanes):
        run = max(lane_start[:sub], default=-1)
        firsts = []
        for e in range(e_count):
            if starts[sub, e]:
                run = pos[sub, e]
            firsts.append(run)
        run = min(lane_end[sub + 1:], default=INT_MAX)
        for e in reversed(range(e_count)):
            if ends[sub, e]:
                run = pos[sub, e]
            r2[sub, e] = firsts[e] + run + 2
    return r2.reshape(-1)


def shared_path(keys, n):
    """2r at each sorted position of the shared path: 32-wide chunks,
    a forward max-scan of run starts and a backward min-scan of ends."""
    r2 = np.zeros(len(keys), np.int64)
    first = np.empty(n, np.int64)
    carry = -1
    for base in range(0, n, 32):
        p = np.arange(base, min(base + 32, n))
        start = (p == 0) | (keys[p] != keys[np.maximum(p - 1, 0)])
        f = np.maximum.accumulate(np.where(start, p, -1))
        first[p] = np.maximum(f, carry)
        carry = first[p[-1]]
    carry = INT_MAX
    for base in range((n - 1) & ~31, -1, -32):
        p = np.arange(base, min(base + 32, n))
        end = (p == n - 1) | (keys[p] != keys[np.minimum(p + 1, n - 1)])
        last = np.minimum.accumulate(np.where(end, p, INT_MAX)[::-1])[::-1]
        last = np.minimum(last, carry)
        carry = last[0]
        r2[p] = first[p] + last + 2
    return r2


def kernel_model(y, xrank2):
    """One voxel through B7's scheme: ``(2r per member, (Σ2r, Σ(2r)²,
    Σ(2r)(2r_x)))``."""
    n = len(y)
    if n <= REGISTER_MAX_MEMBERS:
        lanes = 8 if n <= NARROW_MAX_MEMBERS else 32
        size = pow2_at_least(n, lanes)
        e_count = size // lanes
        j = np.arange(n)
        start_pos = (j % lanes) * e_count + j // lanes  # member e·LANES+sub
    else:
        size = pow2_at_least(n, 32)
        start_pos = np.arange(n)
    keys = np.full(size, PAD_KEY, np.uint32)
    pay = np.zeros(size, np.int64)
    member = np.full(size, -1, np.int64)
    keys[start_pos] = sort_keys(y)
    pay[start_pos] = xrank2
    member[start_pos] = np.arange(n)
    if n <= REGISTER_MAX_MEMBERS:
        merge_levels(keys, lanes, pay, member)
        assert (keys[:-1] <= keys[1:]).all()
        r2 = register_path(keys, lanes)
    else:
        bitonic(keys, pay, member)
        assert (keys[:-1] <= keys[1:]).all()
        r2 = shared_path(keys, n)
    real = np.arange(size) < n
    ranks = np.empty(n, np.int64)
    ranks[member[real]] = r2[real]
    sums = (n * (n + 1), int((r2[real] ** 2).sum()),
            int((r2[real] * pay[real]).sum()))
    return ranks, sums


def series_case(case, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    y = (0.6 * x + rng.normal(size=n)).astype(np.float32)
    if case == "ties":  # tie-heavy, in both series
        x = np.round(x * 2.0).astype(np.float32) / np.float32(2.0)
        y = np.round(y).astype(np.float32)
    elif case == "signed_zeros":  # the quantized case's ±0
        y = (np.round(y) * np.float32(0.0)).astype(np.float32)
        y = np.where(rng.random(n) < 0.5, -y, y).astype(np.float32)
        y[::5] = np.round(y[::5] + rng.normal(size=y[::5].size))
    elif case == "nan":
        y = np.round(y * 2.0).astype(np.float32)
        y[rng.random(n) < 0.1] = np.nan
        y[n // 2] = np.nan
        y[rng.random(n) < 0.1] = -np.float32(0.0)
    return x, y.astype(np.float32)


CASES = ["continuous", "ties", "signed_zeros", "nan"]


@pytest.mark.parametrize("n", [1, 37, 100, 129, 1000, 1500])
@pytest.mark.parametrize("case", CASES)
def test_model_ranks_equal_doubled_ranks(case, n):
    x, y = series_case(case, n, n)
    xrank2 = doubled_ranks(t(x)).numpy()
    ranks, sums = kernel_model(y, xrank2)
    want = doubled_ranks(t(y)).numpy()
    np.testing.assert_array_equal(ranks, want)
    assert sums == (int(want.sum()), int((want * want).sum()),
                    int((want * xrank2).sum()))
    # rho from the model's moments is the plain version's, to the bit.
    rho = rho_from_moments(n, t(xrank2).sum(), (t(xrank2) ** 2).sum(),
                           *(torch.tensor(s) for s in sums))
    plain = spearman_plain(t(y[None]), t(x))[0]
    assert torch.equal(torch.isnan(rho), torch.isnan(plain))
    if not torch.isnan(plain):
        assert float(rho) == float(plain)


@pytest.mark.parametrize("case", CASES)
def test_model_rho_matches_jax(case):
    x, y = series_case(case, 100, 7)
    xrank2 = doubled_ranks(t(x)).numpy()
    _, sums = kernel_model(y, xrank2)
    rho = rho_from_moments(100, t(xrank2).sum(), (t(xrank2) ** 2).sum(),
                           *(torch.tensor(s) for s in sums))
    want = np.asarray(jops.spearman(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(rho), want, atol=ATOL_SPEARMAN_JAX,
                               rtol=0)


@pytest.mark.parametrize("n", [1, 2, 37, 100, 129, 1000, 1025, 4096])
@pytest.mark.parametrize("case", CASES)
def test_sum_of_doubled_ranks_is_n_times_n_plus_one(case, n):
    # The identity B7 writes instead of summing: ties and NaN members
    # included, Σ2r = n(n + 1) for every series.
    _, y = series_case(case, n, 100 + n)
    stack = np.stack([y, np.full(n, 2.5, np.float32), -y])
    got = doubled_ranks(t(stack)).sum(-1)
    assert got.tolist() == [n * (n + 1)] * 3


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32])
def test_odd_even_network_sorts_every_binary_input(n):
    # The 0-1 principle: a network that sorts every 0/1 input sorts all.
    cases = np.arange(2 ** min(n, 16), dtype=np.int64)
    rng = np.random.default_rng(n)
    bits = (cases[:, None] >> np.arange(min(n, 16))) & 1
    if n > 16:  # a sample of the 2^32 inputs, and every sorted prefix
        bits = np.concatenate([rng.integers(0, 2, size=(1 << 16, n)),
                               np.tril(np.ones((n, n), np.int64))])
    x = bits.copy()
    for a, b in odd_even_pairs(n):
        lo, hi = np.minimum(x[:, a], x[:, b]), np.maximum(x[:, a], x[:, b])
        x[:, a], x[:, b] = lo, hi
    assert (np.diff(x, axis=1) >= 0).all()
    assert len(odd_even_pairs(n)) == {2: 1, 4: 5, 8: 19, 16: 63, 32: 191}[n]


def test_keys_order_floats_and_put_nan_last_by_index():
    y = np.array([np.nan, 1.0, -0.0, 0.0, -np.inf, np.inf, np.nan, -2.5,
                  1e-45, -1e-45], np.float32)
    keys = sort_keys(y)
    assert keys[2] == keys[3]  # −0 and +0
    assert NAN_KEY == int(keys[5]) + 1  # the first NaN key follows +inf
    assert keys[0] == NAN_KEY and keys[6] == NAN_KEY + 6
    finite = np.argsort(keys[[1, 2, 4, 5, 7, 8, 9]], kind="stable")
    vals = y[[1, 2, 4, 5, 7, 8, 9]][finite]
    assert (np.diff(vals) >= 0).all()
    assert (keys < PAD_KEY).all() and PAD_KEY < RUN_END
