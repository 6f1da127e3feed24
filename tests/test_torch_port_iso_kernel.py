"""Models of the redesigned B6 (``csrc/raymarch.cu``: its op-by-op sample
from eight taps, kept while a ray stays in one cell in the bisection and
in the march's cache variant, and its own ray setup) and B3
(``csrc/classify.cu``: a grid-stride stream of 128-voxel chunks a warp,
four coalesced voxels a lane), held to the port's plain versions and to
the JAX package on the CPU.

The kernels themselves run only on the card, where ``chip_smoke.py``
holds them to these plain versions; here numpy models of their schemes
must give the plain versions' values: B6's sample bit for bit (it
decides which side of the iso value a sample lies on), B3's split voxel
for voxel.
"""

import numpy as np
import pytest
import torch

from correrender_tpu.ops.pallas import raymarch_kernel as rk

from correrender_tpu_torch.ops.cuda import raymarch_kernel as trk
from correrender_tpu_torch.render.classify import (
    classify_volume_plain,
    premultiplied,
)
from correrender_tpu_torch.render.dvr import to_model_space
from test_torch_port_iso import (
    ATOL_GRAD,
    ATOL_T,
    ISO,
    SENTINEL,
    cams,
    make_volume,
    rotation_y,
)

F32 = np.float32
EPS = 2.0 ** -24  # a half ulp of 1 in float32
ATOL_CLASSIFY_VOLUME = 1e-6  # chip_smoke.py: B3 against its plain version


class TapCache:
    """numpy model of B6's ``IsoTaps``: the sample of ``_sample_slab``
    (the z-lerp by ``wz`` between planes ``z0``, ``z1`` of the bilinear
    sample at the clamped position, each operation one float32 rounding,
    its corner rule at the far edges) from eight taps that are kept while
    the (plane pair, cell) stays the same. ``loads`` counts the cells
    loaded."""

    def __init__(self, vol):
        self.flat = vol.reshape(-1)
        self.planes, self.sub, self.lane = vol.shape
        self.key = None
        self.loads = 0

    def sample(self, z0, z1, wz, raw_u, raw_v):
        sub, lane = self.sub, self.lane
        uc = min(max(raw_u, F32(0)), F32(sub - 1))
        vc = min(max(raw_v, F32(0)), F32(lane - 1))
        iu, iv = min(int(uc), sub - 1), min(int(vc), lane - 1)
        fu, fv = uc - F32(iu), vc - F32(iv)
        off = iu * lane + iv
        if (z0, z1, off) != self.key:
            self.key = (z0, z1, off)
            self.loads += 1
            base = z0 * sub * lane + off
            dz = (z1 - z0) * sub * lane
            du = lane if iu < sub - 1 else 0
            dv = 1 if iv < lane - 1 else 0
            at = (0, dv, du, du + dv)
            self.lo = [self.flat[base + a] for a in at]
            self.hi = [self.flat[base + dz + a] for a in at]
        wl = F32(1) - wz
        tap = [wl * lo + wz * hi for lo, hi in zip(self.lo, self.hi)]
        gu, gv = F32(1) - fu, F32(1) - fv
        a = gv * tap[0] + fv * tap[1]
        b = gv * tap[2] + fv * tap[3]
        return gu * a + fu * b


def march_samples(vol, su, sv, q=4, slabs=None, u0c=0.3, v0c=0.6):
    """The (z0, z1, wz, raw_u, raw_v) of one ray's march in B6's order:
    slab k holds planes max(k − 1, 0) and min(k, planes − 1), sub-step s
    sits at γ = g0 + (k − 1)·gk + s·gs, weight wz = (s + 0.5)/q."""
    planes = vol.shape[0]
    gk, g0 = F32(0.02), F32(0.01)
    gs, inv_q = F32(gk / F32(q)), F32(1) / F32(q)
    out = []
    for k in range(planes + 1) if slabs is None else slabs:
        gbase = g0 + F32(k - 1) * gk
        for s in range(q):
            gamma = gbase + F32(s) * gs
            out.append((max(k - 1, 0), min(k, planes - 1),
                        (F32(s) + F32(0.5)) * inv_q,
                        F32(u0c) + gamma * F32(su),
                        F32(v0c) + gamma * F32(sv)))
    return out


def plain_values(vol, samples):
    """The plain version's ``_sample_slab`` of the same samples."""
    planes, sub, lane = vol.shape
    z0, z1, wz, u, v = (np.asarray(c) for c in zip(*samples))
    flat = torch.from_numpy(vol.reshape(-1))
    return trk._sample_slab(
        flat, torch.from_numpy(z0 * sub * lane),
        torch.from_numpy(z1 * sub * lane), torch.from_numpy(wz),
        torch.from_numpy(u), torch.from_numpy(v), sub - 1, lane - 1, sub,
        lane).numpy()


def _volume(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(F32)


TAP_CASES = {
    # (volume, su, sv, u0c, v0c): the slopes are voxels per unit of γ; a
    # slab spans γ 0.02, so 1.0 crosses a fiftieth of a voxel a slab.
    "sub-steps within one cell": (_volume((6, 9, 11)), 1.0, -0.5, 0.3, 0.6),
    "cell and slab crossings": (_volume((6, 9, 11)), 130.0, -90.0, 0.3,
                                8.6),
    "entering and leaving the plane": (_volume((5, 4, 3)), 40.0, 30.0, -1.5,
                                       -1.2),
    "clamped far edges": (_volume((5, 4, 3)), 400.0, 300.0, 10.0, 10.0),
    "clamped near edges": (_volume((5, 4, 3)), -400.0, -300.0, -10.0,
                           -10.0),
    "planes = 1": (_volume((1, 7, 8)), 60.0, 40.0, 0.3, 0.6),
    "planes = 2": (_volume((2, 7, 8)), 60.0, -40.0, 0.3, 6.6),
    "sub = 1": (_volume((6, 1, 8)), 60.0, 70.0, 0.3, 0.6),
    "lane = 1": (_volume((6, 8, 1)), 70.0, 60.0, 0.3, 0.6),
}


@pytest.mark.parametrize("case", list(TAP_CASES))
def test_tap_cache_equals_the_plain_sample_bit_for_bit(case):
    vol, su, sv, u0c, v0c = TAP_CASES[case]
    samples = march_samples(vol, su, sv, u0c=u0c, v0c=v0c)
    cache = TapCache(vol)
    got = np.asarray([cache.sample(*s) for s in samples], F32)
    want = plain_values(vol, samples)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if case == "sub-steps within one cell":
        # One load a slab: every sub-step of a slab reuses the cell.
        assert cache.loads == vol.shape[0] + 1 < len(samples)
    if case.startswith("clamped"):
        # Every sample sits on a corner of the volume (the clamp), where
        # the clamped neighbours are the corner voxel itself.
        assert cache.loads == vol.shape[0] + 1


def test_tap_cache_carries_the_nan_sentinel_as_the_plain_sample():
    vol = _volume((5, 6, 7), seed=1)
    vol[2, 3, 4] = 1e30  # prepare_raymarch_volume's NaN sentinel
    samples = march_samples(vol, 25.0, 30.0, u0c=2.6, v0c=3.2)
    cache = TapCache(vol)
    got = np.asarray([cache.sample(*s) for s in samples], F32)
    want = plain_values(vol, samples)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got > 1e20).any() and (got < 1e20).any()


def test_tap_cache_serves_the_bisection_from_one_load():
    # The bisection samples γ within one sub-step of the ray: its plane
    # pair (iz, iz + 1) and, mostly, its cell stay the same, so its
    # samples load once; a gradient sample one plane on loads again.
    vol = _volume((6, 9, 11), seed=2)
    _, _, _, u, v = march_samples(vol, 1.0, -0.5, slabs=[3])[-1]
    cache = TapCache(vol)
    bisection = [(2, 3, F32(w), u, v) for w in (0.9, 0.7, 0.75, 0.8, 0.77)]
    got = [cache.sample(*s) for s in bisection]
    assert cache.loads == 1
    gradient = (3, 4, F32(0.77), u, v)
    got.append(cache.sample(*gradient))
    assert cache.loads == 2
    got = np.asarray(got, F32)
    want = plain_values(vol, bisection + [gradient])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# The views of the ray-field comparison: the six axis directions (the eye
# inside the box for one) and a model matrix.
FIELD_VIEWS = {
    "+z": ((0.0, 0.05, 0.62), (0.0, 1.0, 0.0), None),
    "-z, model matrix": ((0.0, 0.05, -0.62), (0.0, 1.0, 0.0),
                         rotation_y(30.0)),
    "-x": ((0.6, 0.1, 0.1), (0.0, 1.0, 0.0), None),
    "+y": ((0.1, -0.6, 0.05), (0.0, 0.0, 1.0), None),
    "eye inside": ((0.02, 0.03, 0.1), (0.0, 1.0, 0.0), None),
}
# iso_ray_fields against the torch fields it replaces for B6 (einsum
# and vector_norm there, explicit sums here): each rounds a handful of
# products and sums in another order. Bars in units of EPS: unit
# directions absolute; inv_da and t0, t1 (where the ray meets the box)
# relative; su and sv absolute against their scale |inv_da|/voxel. On
# these views, where no ray grazes a face, the largest seen are 4, 5, 10
# and 4.
ULPS_DIR, ULPS_INV_DA, ULPS_T, ULPS_SLOPE = 8, 8, 16, 8


@pytest.mark.parametrize("view", list(FIELD_VIEWS))
def test_iso_ray_fields_match_the_torch_ray_fields(view):
    position, up, model = FIELD_VIEWS[view]
    _, cam = cams(position, up=up)
    size = (96, 54)
    plan = trk.plan_raymarch(cam, (12, 14, 18), size, model_matrix=model)
    old = [x.double() for x in trk._ray_fields(cam, size, plan, "cpu")]
    new = trk.iso_ray_fields(cam, size, plan, "cpu")
    assert all(x.dtype == torch.float32 for x in new)
    new = [x.double() for x in new]
    hit = old[4] >= old[3]
    assert torch.equal(hit, new[4] >= new[3])  # the same rays meet the box
    assert 0.3 < float(hit.double().mean())
    origin, dirs = to_model_space(*cam.rays(*size), plan["m_rot"],
                                  plan["m_trans"])
    np.testing.assert_array_equal(origin.numpy(), trk.model_eye(plan, cam))
    assert float((new[5] - dirs.double()).abs().max()) <= ULPS_DIR * EPS
    inv_da = old[2].abs()
    assert float(((new[2] - old[2]).abs() / inv_da).max()) <= (
        ULPS_INV_DA * EPS)
    for ch, axis in ((0, "sub_axis"), (1, "lane_axis")):
        scale = float(inv_da.max()) / abs(float(plan["voxel"][plan[axis]]))
        assert float((new[ch] - old[ch]).abs().max()) <= ULPS_SLOPE * EPS * (
            scale)
    for ch in (3, 4):
        rel = (new[ch] - old[ch]).abs() / old[ch].abs().clamp_min(1e-3)
        assert float(rel[hit].max()) <= ULPS_T * EPS


# The six axis cameras, one of them with a model matrix.
MARCH_VIEWS = {
    "+z": ((0.0, 0.05, 0.62), (0.0, 1.0, 0.0), None),
    "-z, model matrix": ((0.0, 0.05, -0.62), (0.0, 1.0, 0.0),
                         rotation_y(30.0)),
    "+x": ((-0.6, 0.1, 0.1), (0.0, 1.0, 0.0), None),
    "-x": ((0.6, 0.1, 0.1), (0.0, 1.0, 0.0), None),
    "+y": ((0.1, -0.6, 0.05), (0.0, 0.0, 1.0), None),
    "-y": ((0.1, 0.6, 0.05), (0.0, 0.0, 1.0), None),
}


@pytest.mark.parametrize("view", list(MARCH_VIEWS))
def test_iso_march_with_its_own_fields_matches_jax_kernel(view):
    # B6's plain version, whose rays come from iso_ray_fields, against
    # the Pallas kernel in interpret mode: found masks equal, t and the
    # gradients within the bars of tests/test_torch_port_iso.py.
    position, up, model = MARCH_VIEWS[view]
    vol = make_volume(with_nan=True)
    size = (32, 16)
    jcam, tcam = cams(position, up=up)
    jplan = rk.plan_raymarch(jcam, vol.shape, size, q=2, model_matrix=model)
    jprep = rk.prepare_raymarch_volume(vol, jplan["axis_world"],
                                       jplan["flip"], jplan["lane_axis"])
    want = [np.asarray(x) for x in rk.iso_raymarch(
        jprep, jcam, ISO, size, jplan, ns=2, interpret=True, refine_steps=8)]
    plan = trk.plan_raymarch(tcam, vol.shape, size, q=2, model_matrix=model)
    prep = trk.prepare_raymarch_volume(torch.from_numpy(vol),
                                       plan["axis_world"], plan["flip"],
                                       plan["lane_axis"])
    got = [x.numpy() for x in trk.iso_raymarch_plain(prep, tcam, ISO, size,
                                                     plan, refine_steps=8)]
    found = want[0]
    np.testing.assert_array_equal(got[0], found)
    assert 0.1 < found.mean() < 0.9
    np.testing.assert_allclose(got[1][found], want[1][found], atol=ATOL_T,
                               rtol=0)
    for ch in (2, 3, 4):
        g, w = got[ch][found], want[ch][found]
        sane = (np.abs(g) < SENTINEL) & (np.abs(w) < SENTINEL)
        assert sane.mean() >= 0.97, (ch, sane.mean())
        np.testing.assert_allclose(g[sane], w[sane], atol=ATOL_GRAD, rtol=0)
    norms = np.linalg.norm(got[5].astype(np.float64), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=32 * EPS, rtol=0)


def b3_split(n, warps):
    """The voxels B3's lanes classify: warp w takes the 128-voxel chunks
    w, w + W, ...; lane t of a chunk at c loads voxels c + t, c + t + 32,
    c + t + 64, c + t + 96, those below n. Returns the (warp, lane,
    voxel indices) of every step."""
    steps = []
    for w in range(warps):
        for c in range(128 * w, n, 128 * warps):
            steps += [(w, t, [i for i in range(c + t, c + 128, 32) if i < n])
                      for t in range(32)]
    return steps


def lut_lerp(vals, lutp, lo, hi):
    """numpy model of ``lut_lerp`` (``csrc/classify.cu``), float32."""
    res = lutp.shape[0]
    span = F32(hi) - F32(lo)
    if span > 0:
        u = np.clip((vals - F32(lo)) / span, F32(0), F32(1)) * F32(res - 1)
    else:
        u = np.zeros_like(vals)
    u = np.where(np.isnan(vals), F32(0), u)
    i0 = np.minimum(np.floor(u).astype(np.int64), res - 1)
    i1 = np.minimum(i0 + 1, res - 1)
    f = (u - i0.astype(F32))[:, None]
    out = (F32(1) - f) * lutp[i0] + f * lutp[i1]
    return np.where(np.isnan(vals)[:, None], F32(0), out).astype(F32)


@pytest.mark.parametrize("n", [1, 3, 5, 31, 128, 129, 1023, 15_673])
def test_b3_split_covers_every_voxel_once_as_the_plain_version(n):
    rng = np.random.default_rng(n)
    field = (1.5 * rng.normal(size=n)).astype(F32)
    field[::7] = np.nan
    field[1::11] = np.inf
    field[2::13] = -np.inf
    lut = rng.uniform(size=(256, 4)).astype(F32)
    lutp = premultiplied(torch.from_numpy(lut)).numpy()
    steps = b3_split(n, warps=3)
    seen = np.zeros(n, np.int64)
    for _, _, idx in steps:
        np.add.at(seen, idx, 1)
    assert (seen == 1).all()
    # Each of a lane's loads and stores is one of 32 consecutive voxels
    # that its warp reads or writes together.
    for w, t, idx in steps:
        assert all((i - t) % 32 == 0 for i in idx)
    for domain in ((-1.0, 1.0), (0.0, 0.0)):
        want = classify_volume_plain(torch.from_numpy(field).reshape(1, 1, n),
                                     torch.from_numpy(lut), domain).numpy()
        got = np.full((n, 4), np.nan, F32)
        idx = [i for _, _, step in steps for i in step]
        got[idx] = lut_lerp(field[idx], lutp, *domain)
        np.testing.assert_allclose(got, want.reshape(n, 4),
                                   atol=ATOL_CLASSIFY_VOLUME, rtol=0)
