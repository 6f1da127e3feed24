"""PyTorch port (correrender_tpu_torch) vs the JAX package: the isosurface
path. The cubic solver, the fixed-step marcher with its four solvers
(``render/iso.py``), kernel B6's module (the plane-order first-hit
march) and ``iso_render_exact``.

On the CPU the B6 wrapper runs its plain version; chip_smoke.py holds
the kernel to it on the card. The JAX marcher runs in Pallas interpret
mode, as tests/test_raymarch.py runs it. Frames stay under the JAX
package's interpret-mode ceiling (width × height × (planes + 1) × q ≤
3 M, ``raymarch_exact.py:42``): above it JAX on the CPU silently renders
with ``iso_render`` instead of its kernel.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu.calculators.correlation import (
    correlate_field as jax_correlate_field,
)
from correrender_tpu.ops.pallas import raymarch_kernel as rk
from correrender_tpu.render import raymarch_exact as jexact
from correrender_tpu.render.camera import Camera as JaxCamera
from correrender_tpu.render.iso import (
    _smallest_cubic_root01 as jax_cubic_root,
    iso_render as jax_iso_render,
)

from correrender_tpu_torch.calculators.correlation import correlate_field
from correrender_tpu_torch.interop import camera_from_fields
from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda import raymarch_kernel as trk
from correrender_tpu_torch.render import raymarch_exact as texact
from correrender_tpu_torch.render.iso import (
    _smallest_cubic_root01,
    iso_render,
)
from correrender_tpu_torch.utils import fixtures as tfixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (64, 32)
ISO = 0.1
# The cubic solver on the same samples: f32 Cardano and trigonometric
# roots, torch's cube root by pow against XLA's cbrt.
ATOL_CUBIC = 1e-5
# The fixed-step marcher: the same steps; the samples differ only by
# their f32 rounding (XLA fuses products into FMAs), which moves no hit.
MIN_MASK_AGREEMENT = 0.999
ATOL_DEPTH = 1e-5
ATOL_IMAGE = 1e-4
# The exact frame: the kernels refine and take gradients from tent
# weights (TPU) and from clamped trilinear taps (port).
ATOL_IMAGE_EXACT = 1e-3
# B6's plain version against the Pallas kernel: the same samples; the
# refinement's trilinear samples differ in rounding.
ATOL_T = 1e-5
ATOL_GRAD = 1e-4
# A gradient whose ±1-voxel samples touch a NaN voxel carries the 1e30
# sentinel in both kernels (|g| above 1e20); those rays are compared by
# where they lie, not by value.
SENTINEL = 1e20


def make_volume(zs=12, ys=14, xs=18, seed=0, with_nan=False):
    """tests/test_raymarch.py's smoothed random volume."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=(zs, ys, xs)).astype(np.float32)
    for ax in range(3):
        vol = (vol + np.roll(vol, 1, ax) + np.roll(vol, -1, ax)) / 3
    if with_nan:
        vol[zs // 2, ys // 2, xs // 2] = np.nan
    return vol


def cams(position=(0.0, 0.05, 0.62), **kw):
    jcam = JaxCamera(position=position, **kw)
    return jcam, camera_from_fields(jcam.position, jcam.look_at_point,
                                    jcam.up, jcam.fovy, jcam.z_near,
                                    jcam.z_far)


def rotation_y(deg, shift=(0.03, -0.02, 0.01)):
    th = np.deg2rad(deg)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                          [-np.sin(th), 0, np.cos(th)]], np.float32)
    m[:3, 3] = shift
    return m


def _cubic_samples(case, rng, n=4000):
    """Samples at τ = i/3 (i = 0..3) of random polynomials of one degree,
    written in i: ``k·Π(i − R)`` with roots R on a 1/16 grid, real roots
    at least 0.3 apart (0.1 in τ), and ``(i − C)² + D²`` with D ≥ 0.5
    for a complex pair. Every sample is exact in float32, so a quadratic
    or linear sample set has exactly zero leading coefficients (the
    solver's other branches), and every root is well conditioned."""
    i = np.arange(4.0)[:, None]

    def grid(lo, hi):
        return np.round(rng.uniform(lo, hi, n) * 16.0) / 16.0

    k = rng.choice([-1.0, 1.0], n) * np.round(rng.uniform(1, 8, n)) / 8.0
    r = np.sort(np.stack([grid(-2.0, 5.0) for _ in range(3)]), axis=0)
    r[1] = np.maximum(r[1], r[0] + 0.3125)
    r[2] = np.maximum(r[2], r[1] + 0.3125)
    pair = (i - grid(-1.0, 4.0)) ** 2 + grid(0.5, 1.5) ** 2
    half = rng.uniform(size=n) < 0.5
    if case == "cubic":  # three real roots, or one and a complex pair
        f = (i - r[0]) * np.where(half, (i - r[1]) * (i - r[2]), pair)
    elif case == "quadratic":  # two real roots, or none
        f = np.where(half, (i - r[0]) * (i - r[1]), pair)
    else:
        f = i - r[0]
    f = k * f
    assert np.array_equal(f.astype(np.float32), f)
    return f.astype(np.float32)


@pytest.mark.parametrize("case", ["cubic", "quadratic", "linear"])
def test_smallest_cubic_root_matches_jax(case):
    f = _cubic_samples(case, np.random.default_rng(len(case)))
    want = np.asarray(jax_cubic_root(*(jnp.asarray(x) for x in f)))
    got = _smallest_cubic_root01(*(torch.from_numpy(x) for x in f)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert 0.1 < np.isfinite(want).mean() < 0.9  # roots and misses
    np.testing.assert_allclose(got, want, atol=ATOL_CUBIC, rtol=0,
                               equal_nan=True)


def _compare_frames(got, want, atol_image, depth=True,
                    background=(0.0, 0.0, 0.0, 1.0), min_hit=0.1):
    """Hit masks, depth where both hit, image there (bars above). Without
    depth, a hit is a pixel whose colour is not the background's; at
    least ``min_hit`` of the frame must be surface."""
    gi, wi = (x[0] if depth else x for x in (got, want))
    if depth:
        gd, wd = got[1], want[1]
        hit_g, hit_w = np.isfinite(gd), np.isfinite(wd)
    else:
        bg = np.asarray(background, np.float32)[:3]
        hit_g, hit_w = (np.any(np.abs(x[..., :3] - bg) > 1e-6, axis=-1)
                        for x in (gi, wi))
    assert (hit_g == hit_w).mean() >= MIN_MASK_AGREEMENT
    both = hit_g & hit_w
    assert min_hit < both.mean() < 0.9  # a surface, background around it
    if depth:
        assert np.abs(gd - wd)[both].max() <= ATOL_DEPTH
    assert np.abs(gi - wi).max(axis=-1)[both].max() <= atol_image
    return both


ISO_CASES = {
    "bisection": dict(),
    "linear": dict(intersection_mode="linear"),
    "marmitt": dict(intersection_mode="marmitt"),
    "closed surface": dict(closed_surface=True, iso_value=-0.05),
    "model matrix, marmitt": dict(model_matrix=rotation_y(30.0),
                                  intersection_mode="marmitt"),
    "no depth, background": dict(return_depth=False,
                                 background=(0.1, 0.2, 0.3, 1.0)),
    "+x, 4 steps": dict(position=(0.6, 0.1, 0.1), refine_steps=4),
}


@pytest.mark.parametrize("case", list(ISO_CASES))
def test_iso_render_matches_jax(case):
    kw = dict(ISO_CASES[case])
    jcam, tcam = cams(kw.pop("position", (0.0, 0.05, 0.62)))
    iso = kw.pop("iso_value", ISO)
    vol = make_volume()
    kw = dict(dict(image_size=SIZE, voxel_step=0.25, return_depth=True), **kw)
    want = jax_iso_render(jnp.asarray(vol), jcam, iso, **kw)
    got = iso_render(torch.from_numpy(vol), tcam, iso, **kw)
    depth = kw["return_depth"]
    want = tuple(np.asarray(x) for x in want) if depth else np.asarray(want)
    got = tuple(x.numpy() for x in got) if depth else got.numpy()
    _compare_frames(got, want, ATOL_IMAGE, depth=depth,
                    background=kw.get("background", (0.0, 0.0, 0.0, 1.0)))


def test_iso_render_analytic_matches_jax():
    # The analytic solver's f32 Cardano roots are ill-conditioned where a
    # segment is nearly linear (the cubic coefficient near 0): there a
    # 1-ulp difference of a sample (XLA's FMAs) moves the root anywhere
    # in its bracket, in either package. The solvers agree on equal
    # samples (test_smallest_cubic_root_matches_jax); here the masks must
    # agree, every depth lies within one march step of JAX's, and most
    # hits agree to the depth bar and, there, to the exact frame's image
    # bar (a root 1e-5 away can sit where the gradient turns fast).
    jcam, tcam = cams()
    vol = make_volume()
    kw = dict(image_size=SIZE, voxel_step=0.25, return_depth=True,
              intersection_mode="analytic")
    wi, wd = (np.asarray(x) for x in jax_iso_render(jnp.asarray(vol), jcam,
                                                     ISO, **kw))
    gi, gd = (x.numpy() for x in iso_render(torch.from_numpy(vol), tcam,
                                            ISO, **kw))
    hit = np.isfinite(wd)
    assert (np.isfinite(gd) == hit).mean() >= MIN_MASK_AGREEMENT
    both = hit & np.isfinite(gd)
    step = 0.25 * 0.5 / 18  # voxel_step × the smallest voxel extent
    dd = np.abs(gd[both] - wd[both])
    assert dd.max() <= step
    close = both.copy()
    close[both] = dd <= ATOL_DEPTH
    assert close.sum() >= 0.8 * both.sum()
    assert np.abs(gi - wi).max(axis=-1)[close].max() <= ATOL_IMAGE_EXACT


MARCH_CASES = {
    # (camera position, up, refine_steps); the volume has a NaN voxel.
    "+z, refined": ((0.0, 0.05, 0.62), (0.0, 1.0, 0.0), 8),
    "+z, bracket": ((0.0, 0.05, 0.62), (0.0, 1.0, 0.0), 0),
    "-z flipped, refined": ((0.0, 0.05, -0.62), (0.0, 1.0, 0.0), 8),
    "-z flipped, bracket": ((0.0, 0.05, -0.62), (0.0, 1.0, 0.0), 0),
    "+x, refined": ((0.6, 0.1, 0.1), (0.0, 1.0, 0.0), 8),
    "-x flipped, bracket": ((-0.6, 0.1, 0.1), (0.0, 1.0, 0.0), 0),
    "+y, refined": ((0.1, 0.6, 0.05), (0.0, 0.0, 1.0), 8),
    "-y flipped, refined": ((0.1, -0.6, 0.05), (0.0, 0.0, 1.0), 8),
}


@pytest.mark.parametrize("case", list(MARCH_CASES))
def test_iso_raymarch_plain_matches_jax_kernel(case):
    position, up, refine = MARCH_CASES[case]
    vol = make_volume(with_nan=True)
    jcam, tcam = cams(position, up=up)
    jplan = rk.plan_raymarch(jcam, vol.shape, SIZE, q=2)
    jprep = rk.prepare_raymarch_volume(vol, jplan["axis_world"],
                                       jplan["flip"], jplan["lane_axis"])
    want = [np.asarray(x) for x in rk.iso_raymarch(
        jprep, jcam, ISO, SIZE, jplan, ns=2, interpret=True,
        refine_steps=refine)]
    plan = trk.plan_raymarch(tcam, vol.shape, SIZE, q=2)
    assert (plan["axis_world"], plan["flip"]) == (jplan["axis_world"],
                                                  jplan["flip"])
    prep = trk.prepare_raymarch_volume(torch.from_numpy(vol),
                                       plan["axis_world"], plan["flip"],
                                       plan["lane_axis"])
    _build.reset_launch_counts()
    got = [x.numpy() for x in trk.iso_raymarch(prep, tcam, ISO, SIZE, plan,
                                               refine_steps=refine)]
    assert _build.LAUNCHES["raymarch_iso"] == 0  # CPU: the plain version
    found = want[0]
    np.testing.assert_array_equal(got[0], found)
    assert 0.1 < found.mean() < 0.9
    np.testing.assert_allclose(got[1][found], want[1][found], atol=ATOL_T,
                               rtol=0)
    for ch in (2, 3, 4):  # gradients, or the bracket's f values
        g, w = got[ch][found], want[ch][found]
        sane = (np.abs(g) < SENTINEL) & (np.abs(w) < SENTINEL)
        assert sane.mean() >= 0.97, (ch, sane.mean())
        np.testing.assert_allclose(g[sane], w[sane], atol=ATOL_GRAD, rtol=0)
    if refine == 0:
        assert not got[4].any()


def test_iso_raymarch_plain_counts_its_samples():
    vol = make_volume()
    _, tcam = cams()
    plan = trk.plan_raymarch(tcam, vol.shape, SIZE, q=2)
    prep = trk.prepare_raymarch_volume(torch.from_numpy(vol),
                                       plan["axis_world"], plan["flip"],
                                       plan["lane_axis"])
    march, refined = [], []
    found = trk.iso_raymarch_plain(prep, tcam, ISO, SIZE, plan,
                                   refine_steps=0, samples=march)[0]
    trk.iso_raymarch_plain(prep, tcam, ISO, SIZE, plan, refine_steps=8,
                           samples=refined)
    assert refined[0] - march[0] == 14 * int(found.sum())
    # At most the planes + 1 slabs of q sub-steps per ray.
    assert 0 < march[0] <= SIZE[0] * SIZE[1] * (plan["planes"] + 1) * 2


def test_iso_raymarch_refuses_other_devices():
    _, tcam = cams()
    plan = trk.plan_raymarch(tcam, (12, 14, 18), SIZE)
    vol = torch.zeros((18, 14, 12), device="meta")
    with pytest.raises(ValueError, match="no raymarch kernel"):
        trk.iso_raymarch(vol, tcam, ISO, SIZE, plan)


EXACT_CASES = {
    "bisection": dict(),
    "bisection, flipped": dict(position=(0.0, 0.05, -0.62)),
    "bisection, model matrix": dict(model_matrix=rotation_y(30.0)),
    "bisection, +x, nan": dict(position=(0.6, 0.1, 0.1), with_nan=True),
    "marmitt": dict(intersection_mode="marmitt"),
    "marmitt, +y": dict(intersection_mode="marmitt",
                        position=(0.1, 0.6, 0.05), up=(0.0, 0.0, 1.0)),
}


@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_iso_render_exact_matches_jax(case):
    # Replaces test_torch_port_exact.py's test_iso_render_exact_is_not_ported.
    kw = dict(EXACT_CASES[case])
    vol = make_volume(with_nan=kw.pop("with_nan", False))
    jcam, tcam = cams(kw.pop("position", (0.0, 0.05, 0.62)),
                      up=kw.pop("up", (0.0, 1.0, 0.0)))
    kw = dict(dict(image_size=SIZE, voxel_step=0.25, return_depth=True), **kw)
    jplan = rk.plan_raymarch(jcam, vol.shape, SIZE,
                             model_matrix=kw.get("model_matrix"))
    q = jexact._q_from_voxel_step(jplan, kw["voxel_step"])
    assert (SIZE[0] * SIZE[1] * (jplan["planes"] + 1) * q
            <= jexact._INTERPRET_MAX_SAMPLES)
    want = tuple(np.asarray(x) for x in jexact.iso_render_exact(
        jnp.asarray(vol), jcam, ISO, **kw))
    prepared = texact.ExactPrepared(torch.from_numpy(vol))
    stages = []
    got = texact.iso_render_exact(
        torch.from_numpy(vol), tcam, ISO, prepared=prepared,
        on_stage=lambda name, _: stages.append(name), **kw)
    assert len(prepared._by_key) == 1  # it went through the marcher
    assert stages == ["layout", "march", "shade"]
    got = tuple(x.numpy() for x in got)
    assert got[0].shape == (SIZE[1], SIZE[0], 4)
    assert np.isfinite(got[0]).all()
    _compare_frames(got, want, ATOL_IMAGE_EXACT)


def test_iso_render_exact_routes_closed_surfaces_to_iso_render():
    vol = torch.from_numpy(make_volume())
    _, tcam = cams()
    kw = dict(image_size=(24, 16), closed_surface=True, return_depth=True)
    prepared = texact.ExactPrepared(vol)
    got = texact.iso_render_exact(vol, tcam, -0.05, prepared=prepared, **kw)
    want = iso_render(vol, tcam, -0.05, **kw)
    assert not prepared._by_key  # no marcher layout was built
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_iso_render_exact_routes_mixed_sign_cameras_to_iso_render():
    # The JAX planner accepts this camera and renders the rays that run
    # against the principal axis as background (ADVICE #1); the port
    # refuses to plan it and draws the frame with iso_render.
    vol = make_volume()
    jcam, tcam = cams((0.5, 0.45, 0.05), fovy=np.deg2rad(150.0))
    with pytest.raises(trk.RaymarchUnsupported, match="mixed-sign"):
        trk.plan_raymarch(tcam, vol.shape, SIZE)
    kw = dict(image_size=SIZE, voxel_step=0.5, return_depth=True)
    _build.reset_launch_counts()
    got = texact.iso_render_exact(torch.from_numpy(vol), tcam, ISO, **kw)
    want = iso_render(torch.from_numpy(vol), tcam, ISO, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    jwant = tuple(np.asarray(x) for x in jax_iso_render(
        jnp.asarray(vol), jcam, ISO, **kw))
    # The wide-angle view holds the box in a few dozen pixels.
    _compare_frames(tuple(x.numpy() for x in got), jwant, ATOL_IMAGE,
                    min_hit=0.002)


def test_iso_render_exact_refuses_an_unknown_solver():
    # The JAX package renders an unknown name as bisection.
    vol = torch.from_numpy(make_volume())
    with pytest.raises(ValueError, match="intersection_mode"):
        texact.iso_render_exact(vol, cams()[1], ISO, image_size=(16, 8),
                                intersection_mode="newton")


@pytest.mark.parametrize("mode", ["bisection", "marmitt"])
def test_slice_field_to_iso_frame_matches_jax(mode):
    # The slice end to end: a planted-box stack → Pearson field → the
    # exact isosurface of r = 0.5.
    data = tfixtures.synth_box_ensemble(xs=16, ys=12, zs=8, members=30)
    stack = np.ascontiguousarray(np.moveaxis(data, 0, -1))
    ref = stack[4, 3, 4].copy()
    jcam, tcam = cams((0.05, 0.3, 0.85))
    kw = dict(image_size=SIZE, voxel_step=0.25, return_depth=True,
              intersection_mode=mode)
    jfield = jax_correlate_field(jnp.asarray(stack), jnp.asarray(ref))
    want = tuple(np.asarray(x) for x in jexact.iso_render_exact(
        jfield, jcam, 0.5, **kw))
    field = correlate_field(torch.from_numpy(stack), torch.from_numpy(ref))
    # The Pearson fields agree to ~1e-7 (test_torch_port_pearson.py).
    assert float(np.abs(field.numpy() - np.asarray(jfield)).max()) <= 1e-6
    got = tuple(x.numpy() for x in texact.iso_render_exact(
        field, tcam, 0.5, **kw))
    _compare_frames(got, want, ATOL_IMAGE_EXACT, min_hit=0.05)


def test_iso_and_streamed_paths_never_import_jax():
    # In a fresh interpreter: tests/conftest.py imports jax in this one.
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import sys
        import torch
        from correrender_tpu_torch.calculators.correlation import (
            pearson_streamed)
        from correrender_tpu_torch.render.camera import Camera
        from correrender_tpu_torch.render.raymarch_exact import (
            iso_render_exact)
        from correrender_tpu_torch.utils.fixtures import (
            synth_box_ensemble)
        data = torch.from_numpy(synth_box_ensemble(8, 8, 4, 20))
        field = pearson_streamed([data[:8], data[8:]], data[:, 2, 2, 2])
        for closed in (False, True):
            img = iso_render_exact(field, Camera(), 0.5, image_size=(16, 8),
                                   closed_surface=closed)
            assert img.shape == (8, 16, 4)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib",
                                            "correrender_tpu"))
        print("LOADED", bad)
        assert not bad, bad
    """)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout
