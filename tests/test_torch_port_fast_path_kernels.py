"""PyTorch port (correrender_tpu_torch): models of the arithmetic of
kernels K1 (``csrc/pearson.cu``, the tiled Pearson) and K3
(``csrc/shearwarp.cu``, the tap tables and the composite), held on the
CPU to their plain versions.

The plain versions are held to the JAX package by
``test_pearson_kernel_wrapper_matches_jax`` and
``test_composite_plain_matches_jax_scan``; the CUDA kernels run only on
the card, where chip_smoke.py holds them to the plain versions. These
tests hold what the kernels compute, step for step, to the plain
versions' answers: K1's tiles, copies and summation order; K3's tap
tables, composite and bf16 rounding.
"""

import numpy as np
import pytest
import torch

from correrender_tpu_torch.ops.cuda.pearson_kernel import pearson_plain
from correrender_tpu_torch.ops.cuda.shearwarp_kernel import (
    round_bf16,
    shearwarp_composite_plain,
)

ATOL_PEARSON = 2e-5  # chip_smoke.py: K1 against its plain version

# -- K1: the tiled Pearson, as csrc/pearson.cu runs it ---------------------

THREADS = 256  # kThreads
NARROW_LANES, NARROW_MAX_MEMBERS = 4, 128  # kNarrowLanes, kNarrowMaxMembers
TILE_TARGET_BYTES = 32 * 1024  # kTileTargetBytes


def lanes_for(n):
    return NARROW_LANES if n <= NARROW_MAX_MEMBERS else 32


def tile_voxels(n, lanes):
    """``tile_shape``: whole passes of the block's groups, at least one,
    up to the target bytes."""
    groups = THREADS // lanes
    pass_bytes = groups * n * 4
    passes = 1 if pass_bytes >= TILE_TARGET_BYTES else (
        TILE_TARGET_BYTES // pass_bytes)
    return groups * passes


def tile_copies(v, n, tile):
    """Per tile: (first voxel, byte offset, bulk bytes, tail bytes) of
    ``issue``."""
    out = []
    for first in range(0, v, tile):
        count = min(tile, v - first)
        nbytes = count * n * 4
        out.append((first, first * n * 4, nbytes & ~15, nbytes - (nbytes & ~15)))
    return out


def f32(x):
    return np.float32(x)


def fmaf(a, b, c):
    """f32 fused multiply-add (a·b is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def tiled_pearson_model(series, ref):
    """K1's tiled regime: per voxel, LANES lanes each walk the members
    j = lane, lane + LANES, ... starting at the group's bank rotation,
    then a butterfly of xor shuffles, then ``pearson_r``."""
    v, n = series.shape
    lanes = lanes_for(n)
    tile = tile_voxels(n, lanes)
    groups = THREADS // lanes
    x = ref.astype(np.float32)
    part_x = np.zeros(32, np.float32)
    part_xx = np.zeros(32, np.float32)
    for lane in range(32):  # reference_sums: the first warp, then a butterfly
        for j in range(lane, n, 32):
            part_x[lane] = f32(part_x[lane] + x[j])
            part_xx[lane] = fmaf(x[j:j + 1], x[j:j + 1], part_xx[lane])[0]
    sx, sxx = butterfly(part_x[None], 32)[0], butterfly(part_xx[None], 32)[0]

    local = np.arange(v) % tile
    g_in_warp = (local % groups) % (32 // lanes)
    rot = (g_in_warp * (lanes - n)) % 32 * (n >= 32)
    sy = np.zeros((v, lanes), np.float32)
    syy = np.zeros((v, lanes), np.float32)
    sxy = np.zeros((v, lanes), np.float32)
    rows = np.arange(v)[:, None]
    for j0 in range(0, n, lanes):
        j = j0 + np.arange(lanes)[None, :]
        live = j < n
        jj = (j + rot[:, None]) % n
        yj = np.where(live, series[rows, jj], 0).astype(np.float32)
        xj = np.where(live, x[jj], 0).astype(np.float32)
        sy = np.where(live, (sy + yj).astype(np.float32), sy)
        syy = np.where(live, fmaf(yj, yj, syy), syy)
        sxy = np.where(live, fmaf(xj, yj, sxy), sxy)
    sy, syy, sxy = (butterfly(a, lanes) for a in (sy, syy, sxy))
    nn = np.float32(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        num = nn * sxy - sx * sy
        den = np.sqrt((nn * sxx - sx * sx) * (nn * syy - sy * sy))
        return (num / den).astype(np.float32)


def butterfly(a, lanes):
    """The xor-shuffle reduction over ``lanes`` lanes: lane 0's sum."""
    a = a.astype(np.float32)
    off = lanes // 2
    while off:
        a = (a + a[:, np.arange(a.shape[1]) ^ off]).astype(np.float32)
        off //= 2
    return a[:, 0]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 37, 100, 128, 1000, 1025])
def test_pearson_tiles_and_order_match_plain(n):
    lanes = lanes_for(n)
    tile = tile_voxels(n, lanes)
    v = 2 * tile + 5  # a ragged last tile
    assert v % tile != 0
    # Every tile starts 16-byte aligned, copies a 16-byte multiple in bulk
    # and at most 12 bytes by plain loads, and the copies cover the series
    # exactly once.
    copies = tile_copies(v, n, tile)
    assert all(off % 16 == 0 and bulk % 16 == 0 and tail in (0, 4, 8, 12)
               for _, off, bulk, tail in copies)
    assert sum(bulk + tail for *_, bulk, tail in copies) == v * n * 4
    assert tile % 8 == 0 and tile % (THREADS // lanes) == 0

    rng = np.random.default_rng(n)
    series = rng.normal(size=(v, n)).astype(np.float32)
    series[: v // 3] += 0.7 * rng.normal(size=n).astype(np.float32)
    series[3] = 0.0  # zero variance
    ref = rng.normal(size=n).astype(np.float32)
    got = tiled_pearson_model(series, ref)
    want = pearson_plain(torch.from_numpy(series), torch.from_numpy(ref))
    want = want.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3])
    if n <= 2:  # every order of two terms gives the same sums
        np.testing.assert_allclose(got, want, atol=ATOL_PEARSON, rtol=0)
        return
    # The bar holds where the variance term is well conditioned. Where a
    # row's variance is under 1% of its mean square (κ = nΣy²/(nΣy² −
    # (Σy)²) > 100; at n = 3, 1 in a few hundred normal rows), any other
    # summation order moves r by up to about n·2⁻²⁴·κ, as far as the
    # plain version itself is off float64: there the model is held to
    # float64 within that.
    yd, xd = series.astype(np.float64), ref.astype(np.float64)
    sy, syy = yd.sum(1), (yd * yd).sum(1)
    with np.errstate(divide="ignore", invalid="ignore"):
        kappa = n * syy / (n * syy - sy * sy)
        r64 = (n * yd @ xd - xd.sum() * sy) / np.sqrt(
            (n * xd @ xd - xd.sum() ** 2) * (n * syy - sy * sy))
    ill = (kappa > 100) & ~np.isnan(want)
    assert ill.sum() <= v // 100, ill.sum()
    np.testing.assert_allclose(got[~ill], want[~ill], atol=ATOL_PEARSON,
                               rtol=0)
    assert (np.abs(got - r64)[ill]
            <= ATOL_PEARSON + n * 2.0**-24 * kappa[ill]).all()


def test_bank_rotation_spreads_the_warp_over_32_banks():
    """Group g of a warp reads bank (g·n + rot + l) mod 32 = g·LANES + l
    for every n ≥ 32 (a shorter row starts at member 0)."""
    for n in (32, 33, 37, 64, 100, 127, 128, 1000, 1025, 2048):
        lanes = lanes_for(n)
        g = np.arange(32 // lanes)[:, None]
        rot = (g * (lanes - n)) % 32
        banks = (g * n + rot + np.arange(lanes)[None, :]) % 32
        assert sorted(banks.ravel()) == list(range(32)), n


# -- K3: the tap tables and the composite, as csrc/shearwarp.cu runs them --

EPS = np.float32(1e-6)


def composite_setup(case):
    """tests/test_pallas.py:98-118, and K3's boundaries."""
    rng = np.random.default_rng(0)
    s, yv, xv, hi, wi = 20, 24, 40, 48, 64
    g = np.linspace(1.0, 1.8, s)
    if case == "ragged":
        hi, wi = 37, 45
    elif case == "S=1":
        s, g = 1, np.ones(1)
    elif case == "Yv=1":
        yv = 1
    elif case == "Xv=1":
        xv = 1
    elif case == "inert":
        g[[0, 3, 4, 11]] = (0.0, 1e-6, -0.5, 1e-7)
    elif case == "missed":
        g[[5, 6]] = (40.0, -40.0)
    cvol = rng.uniform(size=(s, yv, xv, 4)).astype(np.float32) * 0.3
    arrays = dict(
        g=g.astype(np.float32),
        coords_y=np.linspace(-0.2, 0.2, yv).astype(np.float32),
        coords_x=np.linspace(-0.25, 0.25, xv).astype(np.float32),
        grid_v=np.linspace(-0.22, 0.22, hi).astype(np.float32),
        grid_u=np.linspace(-0.27, 0.27, wi).astype(np.float32),
        len_factor=(1.0 + 0.2 * rng.uniform(size=(hi, wi))).astype(
            np.float32),
    )
    kstop = rng.uniform(0.0, s, size=(hi, wi)).astype(np.float32)
    cf = torch.from_numpy(cvol).to(torch.bfloat16)
    args = {k: torch.from_numpy(a) for k, a in arrays.items()}
    args["eye_uv"] = (0.05, -0.03)
    return cf, args, torch.from_numpy(kstop)


def tap_table(g, coords, grid, e):
    """``composite_taps_kernel`` for one axis: (t, w0, w1) per (slice,
    pixel) as int32 and f32, with q = e + (grid − e)·g rounded as a
    product and a sum, and zero weights for an inert slice."""
    n = coords.shape[0]
    d = coords[1] - coords[0] if n > 1 else torch.tensor(1.0)
    e = torch.tensor(e, dtype=torch.float32)
    q = e + (grid[None, :] - e) * g[:, None]
    pos = torch.clamp((q - coords[0]) / d, -2.0, float(n) + 1.0)
    t = torch.floor(pos).to(torch.int32)

    def weight(idx):
        inside = (idx >= 0) & (idx < n)
        c = coords[idx.clamp(0, n - 1).long()]
        w = round_bf16(torch.clamp_min(1.0 - (q - c).abs() / d, 0.0))
        return torch.where(inside, w, 0.0)

    live = (g > EPS)[:, None]
    return (torch.where(live, t, 0), torch.where(live, weight(t), 0.0),
            torch.where(live, weight(t + 1), 0.0))


def dense(t, w0, w1, n):
    """A table's taps as the dense (S, pixels, n) weights they stand for."""
    out = torch.zeros(t.shape + (n + 5,), dtype=torch.float32)
    idx = t.long() + 2  # t runs from −2 to n + 1
    out.scatter_(-1, idx[..., None], w0[..., None])
    out.scatter_add_(-1, idx[..., None] + 1, w1[..., None])
    return out[..., 2:n + 2]


def plain_weights(args, axis):
    """The plain composite's tent weights (shearwarp_kernel.py:130-133)."""
    coords, grid = ((args["coords_y"], args["grid_v"]) if axis == "v"
                    else (args["coords_x"], args["grid_u"]))
    e = args["eye_uv"][1] if axis == "v" else args["eye_uv"][0]
    n = coords.shape[0]
    d = coords[1] - coords[0] if n > 1 else 1.0
    q = e + (grid[None, :] - e) * args["g"][:, None]
    return round_bf16(torch.clamp_min(1.0 - (q[..., None] - coords).abs() / d,
                                      0.0))


CASES = ["base", "ragged", "S=1", "Yv=1", "Xv=1", "inert", "missed"]


@pytest.mark.parametrize("case", CASES)
def test_tap_tables_equal_the_plain_weights(case):
    _, args, _ = composite_setup(case)
    live = args["g"] > EPS
    for axis, coords, grid, e in (
        ("v", args["coords_y"], args["grid_v"], args["eye_uv"][1]),
        ("u", args["coords_x"], args["grid_u"], args["eye_uv"][0]),
    ):
        t, w0, w1 = tap_table(args["g"], coords, grid, e)
        # The table entry packs both bf16 weights into one word exactly.
        bits0 = w0.view(torch.int32) >> 16 & 0xFFFF
        bits1 = w1.view(torch.int32) & ~0xFFFF
        word = bits0 | bits1
        assert torch.equal((word << 16).view(torch.float32), w0)
        assert torch.equal((word & ~0xFFFF).view(torch.float32), w1)
        got = dense(t, w0, w1, coords.shape[0])
        want = plain_weights(args, axis)
        assert torch.equal(got[live].view(torch.int32),
                           want[live].view(torch.int32)), axis
        assert not got[~live].any()  # an inert slice has no taps


def composite_model(cf, args, kstop, attenuation=80.0, slab=0.02):
    """``composite_kernel`` over every pixel at once: per slice, the four
    taps from the tables (zero outside the slice), the v-resample rounded
    to bf16, the u-resample, then the per-sample opacity and OVER in the
    kernel's order."""
    s, yv, xv, _ = cf.shape
    hi, wi = args["len_factor"].shape
    e_u, e_v = args["eye_uv"]
    tv = tap_table(args["g"], args["coords_y"], args["grid_v"], e_v)
    tu = tap_table(args["g"], args["coords_x"], args["grid_u"], e_u)
    vol = cf.to(torch.float32)
    acc = torch.zeros((hi, wi, 4))
    thickness0 = slab * args["len_factor"]

    def gather(k, ys, xs):
        inside = (ys >= 0) & (ys < yv) & (xs >= 0) & (xs < xv)
        val = vol[k][ys.clamp(0, yv - 1).long(), xs.clamp(0, xv - 1).long()]
        return torch.where(inside[..., None], val, 0.0)

    for k in range(s):
        ty, wy0, wy1 = (a[k][:, None] for a in tv)
        tx, wx0, wx1 = (a[k][None, :] for a in tu)
        col = []
        for c in (0, 1):
            a = gather(k, ty.expand(hi, wi), (tx + c).expand(hi, wi))
            b = gather(k, (ty + 1).expand(hi, wi), (tx + c).expand(hi, wi))
            col.append(round_bf16(wy0[..., None] * a + wy1[..., None] * b))
        smp = wx0[..., None] * col[0] + wx1[..., None] * col[1]
        tau = smp[..., 3]
        thickness = thickness0
        if kstop is not None:
            thickness = thickness * torch.clamp(kstop - float(k), 0.0, 1.0)
        al = 1.0 - torch.exp(-tau * thickness * attenuation)
        w = (1.0 - acc[..., 3]) * (al / torch.clamp_min(tau, EPS))
        acc[..., :3] += w[..., None] * smp[..., :3]
        acc[..., 3] += (1.0 - acc[..., 3]) * al
    return acc[..., :3], acc[..., 3]


@pytest.mark.parametrize("use_kstop", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_composite_from_tables_matches_plain(case, use_kstop):
    cf, args, kstop = composite_setup(case)
    kstop = kstop if use_kstop else None
    rgb, alpha = composite_model(cf, args, kstop)
    rgb_p, alpha_p = shearwarp_composite_plain(
        cf, **args, slab_thickness=0.02, attenuation=80.0, kstop=kstop)
    assert float(alpha.max()) > 0.1  # the slices were composited
    np.testing.assert_allclose(alpha.numpy(), alpha_p.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(rgb.numpy(), rgb_p.numpy(), atol=1e-6, rtol=0)


# -- K3's bf16 rounding: cvt.rn.bf16x2.f32, modelled as integer RNE --------


def rne_bf16_bits(x):
    """Round-to-nearest-even of f32 to bf16 on the bits (finite values and
    infinities): add 0x7FFF plus the kept part's lowest bit, drop 16."""
    bits = x.view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def packed_pair(a, b):
    """Two values rounded into one word as __floats2bfloat162_rn packs
    them (a low, b high), then unpacked as __low2float/__high2float."""
    word = (rne_bf16_bits(a).astype(np.uint32)
            | (rne_bf16_bits(b).astype(np.uint32) << 16))
    low = (word << 16).view(np.float32)
    high = (word & 0xFFFF0000).view(np.float32)
    return low, high


def sweep(kind):
    rng = np.random.default_rng(7)
    if kind == "ties":  # exactly half way, both parities, both signs
        kept = rng.integers(0, 0x7F80, size=4096, dtype=np.uint32)
        bits = (kept << 16) | 0x8000
        bits = np.concatenate([bits, bits | 0x80000000])
    elif kind == "signed zeros":
        bits = np.array([0, 0x80000000, 1, 0x80000001, 0x7FFF, 0x8000,
                         0x8001, 0x80008000], np.uint32)
    elif kind == "subnormals":
        bits = rng.integers(1, 0x800000, size=8192, dtype=np.uint32)
        bits = np.concatenate([bits, bits | 0x80000000, [0x7FFFFF, 0x7F8000,
                                                         0x7F7FFF, 0x8000]])
    elif kind == "near overflow":
        top = np.arange(0x7F7F0000, 0x7F800000, 7, dtype=np.uint32)
        bits = np.concatenate([top, top | 0x80000000,
                               [0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF,
                                0x7F800000, 0xFF800000]])
    else:  # ordinary values
        bits = rng.integers(0, 0x7F800000, size=1 << 16, dtype=np.uint32)
        bits = np.concatenate([bits, bits | 0x80000000])
    return bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("kind", ["ties", "signed zeros", "subnormals",
                                  "near overflow", "ordinary"])
def test_packed_bf16_rounding_equals_torch(kind):
    x = sweep(kind)
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(rne_bf16_bits(x), want.view(np.uint16))
    half = x.shape[0] // 2
    low, high = packed_pair(x[:half], x[half:2 * half])
    np.testing.assert_array_equal(low.view(np.uint32),
                                  round_bf16(torch.from_numpy(x[:half]))
                                  .numpy().view(np.uint32))
    np.testing.assert_array_equal(high.view(np.uint32),
                                  round_bf16(torch.from_numpy(
                                      x[half:2 * half])).numpy()
                                  .view(np.uint32))


def test_nan_rounds_to_nan():
    x = np.array([np.nan, -np.nan], np.float32)
    assert torch.isnan(round_bf16(torch.from_numpy(x))).all()
