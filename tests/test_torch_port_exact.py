"""PyTorch port (correrender_tpu_torch) vs the JAX package: the exact DVR
path. Sampling, the fixed-step marcher (``render/dvr.py``), kernel B5's
module (plan, transfer-function hinges, the plane-order march) and
``dvr_render_exact``.

On the CPU the B5 wrapper runs its plain version; chip_smoke.py holds
the kernel to it on the card. The JAX marcher runs in Pallas interpret
mode, as tests/test_raymarch.py runs it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu.ops.pallas import raymarch_kernel as rk
from correrender_tpu.render import raymarch_exact as jexact
from correrender_tpu.render.camera import Camera as JaxCamera
from correrender_tpu.render.dvr import dvr_render as jax_dvr_render
from correrender_tpu.render import pipeline as jax_pipeline
from correrender_tpu.render.pipeline import (
    render_correlation as jax_render_correlation,
)
from correrender_tpu.render.sampling import (
    ray_box_intersect as jax_ray_box_intersect,
    sample_trilinear as jax_sample_trilinear,
)
from correrender_tpu.render.tf import TransferFunction as JaxTF
from correrender_tpu.utils import fixtures as jfixtures
from correrender_tpu.utils import metrics as jmetrics

from correrender_tpu_torch.interop import (
    camera_from_fields,
    stack_from_numpy,
    transfer_function_from_arrays,
)
from correrender_tpu_torch.ops.cuda import _build
from correrender_tpu_torch.ops.cuda import raymarch_kernel as trk
from correrender_tpu_torch.render import raymarch_exact as texact
from correrender_tpu_torch.render.dvr import dvr_render
from correrender_tpu_torch.render.pipeline import render_correlation
from correrender_tpu_torch.render.sampling import (
    ray_box_intersect,
    sample_trilinear,
)
from correrender_tpu_torch.render.tf import TransferFunction

SIZE = (64, 32)
# Plain march vs the Pallas kernel (interpret) on rays that never reach
# alpha 0.999: the same f32 arithmetic up to summation order
# (tests/test_raymarch.py holds the kernel to its numpy mirror at 2e-5).
ATOL_MARCH = 2e-5
# A saturating ray: the port stops it at alpha 0.999, the TPU kernel
# stops its 8×128 subtile later, so the two differ by at most 1 − 0.999.
ATOL_SATURATED = 1e-3
ATOL_EXACT = 1e-3
MIN_SSIM_EXACT = 0.9999
# The fixed-step marcher: the same f32 steps; a few hundred OVER steps
# accumulate summation-order differences of the trilinear sample.
ATOL_DVR = 1e-5


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


def port_tf(jtf):
    return transfer_function_from_arrays(
        np.asarray(jtf.lut), jtf.domain, color_points=jtf.color_points,
        opacity_points=jtf.opacity_points)


def tfs(vol):
    jtf = JaxTF.from_control_points(
        color_points=[(0.0, (0.0, 0.2, 1.0)), (0.5, (0.1, 1.0, 0.1)),
                      (1.0, (1.0, 0.1, 0.0))],
        opacity_points=[(0.0, 0.0), (0.4, 0.3), (1.0, 0.9)],
        domain=(float(np.nanmin(vol)), float(np.nanmax(vol))))
    return jtf, port_tf(jtf)


def rotation_y(deg, shift=(0.03, -0.02, 0.01)):
    th = np.deg2rad(deg)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                          [-np.sin(th), 0, np.cos(th)]], np.float32)
    m[:3, 3] = shift
    return m


def depth_wall():
    """An opaque wall at eye distance 0.55 across the lower half."""
    dlim = np.full((SIZE[1], SIZE[0]), np.inf, np.float32)
    dlim[SIZE[1] // 2:] = 0.55
    return dlim


MARCH_CASES = {
    # tests/test_raymarch.py:137-176, at an attenuation where no ray
    # saturates.
    "+z": dict(position=(0.0, 0.05, 0.62)),
    "-z flipped": dict(position=(0.0, 0.05, -0.62)),
    "+x": dict(position=(0.6, 0.1, 0.1)),
    "nan ignore": dict(with_nan=True),
    "nan yellow": dict(with_nan=True, nan_mode="yellow"),
    "restriction euclidean": dict(
        restriction=((0.02, -0.01, 0.0), 0.12, "Euclidean")),
    "restriction chebyshev": dict(
        restriction=((0.02, -0.01, 0.0), 0.09, "Chebyshev")),
    "depth limit": dict(depth_limit=True),
    "model matrix": dict(model_matrix=rotation_y(30.0)),
    # Past the TPU's brick buckets: JAX plans it only with larger ones.
    "zoom-out": dict(position=(0.02, 0.03, 5.0), buckets=10**6),
    "saturating": dict(attenuation=60.0, atol=ATOL_SATURATED),
}


@pytest.mark.parametrize("case", list(MARCH_CASES))
def test_dvr_raymarch_matches_jax_kernel(case):
    kw = dict(MARCH_CASES[case])
    vol = make_volume(with_nan=kw.pop("with_nan", False))
    jcam, tcam = cams(kw.pop("position", (0.0, 0.05, 0.62)))
    jtf, ttf = tfs(vol)
    atol = kw.pop("atol", ATOL_MARCH)
    buckets = kw.pop("buckets", None)
    model = kw.pop("model_matrix", None)
    if kw.pop("depth_limit", False):
        kw["depth_limit"] = depth_wall()
    kw.setdefault("attenuation", 8.0)

    bucket_kw = {}
    if buckets is not None:
        with pytest.raises(rk.RaymarchUnsupported):
            rk.plan_raymarch(jcam, vol.shape, SIZE, q=2)
        bucket_kw = dict(max_bu=buckets, max_bv=buckets)
    jplan = rk.plan_raymarch(jcam, vol.shape, SIZE, q=2, model_matrix=model,
                             **bucket_kw)
    jprep = rk.prepare_raymarch_volume(vol, jplan["axis_world"],
                                       jplan["flip"], jplan["lane_axis"])
    jkw = dict(kw)
    if "depth_limit" in jkw:
        jkw["depth_limit"] = jnp.asarray(jkw["depth_limit"])
    want_rgb, want_a = (np.asarray(x) for x in rk.dvr_raymarch(
        jprep, jcam, jtf, SIZE, jplan, ns=2, interpret=True, **jkw))

    plan = trk.plan_raymarch(tcam, vol.shape, SIZE, q=2, model_matrix=model)
    prep = trk.prepare_raymarch_volume(torch.from_numpy(vol),
                                       plan["axis_world"], plan["flip"],
                                       plan["lane_axis"])
    _build.reset_launch_counts()
    rgb, a = trk.dvr_raymarch(prep, tcam, ttf, SIZE, plan, **kw)
    assert _build.LAUNCHES["raymarch_dvr"] == 0  # CPU: the plain version
    saturated = want_a.max() >= trk._EXIT_ALPHA
    assert saturated == (atol == ATOL_SATURATED), want_a.max()
    assert want_a.max() > 0.05  # the frame is not empty
    np.testing.assert_allclose(a.numpy(), want_a, atol=atol, rtol=0)
    np.testing.assert_allclose(rgb.numpy(), want_rgb, atol=atol, rtol=0)


def test_dvr_raymarch_refuses_other_devices():
    _, tcam = cams()
    _, ttf = tfs(np.zeros(3))
    plan = trk.plan_raymarch(tcam, (12, 14, 18), SIZE)
    vol = torch.zeros((12, 14, 18), device="meta")
    with pytest.raises(ValueError, match="no raymarch kernel"):
        trk.dvr_raymarch(vol, tcam, ttf, SIZE, plan)


def test_restriction_and_depth_limit_cut_the_frame():
    vol = make_volume()
    _, tcam = cams()
    _, ttf = tfs(vol)
    plan = trk.plan_raymarch(tcam, vol.shape, SIZE, q=2)
    prep = trk.prepare_raymarch_volume(torch.from_numpy(vol),
                                       plan["axis_world"], plan["flip"],
                                       plan["lane_axis"])
    _, free = trk.dvr_raymarch(prep, tcam, ttf, SIZE, plan)
    _, ball = trk.dvr_raymarch(
        prep, tcam, ttf, SIZE, plan,
        restriction=((0.02, -0.01, 0.0), 0.12, "Euclidean"))
    _, wall = trk.dvr_raymarch(prep, tcam, ttf, SIZE, plan,
                               depth_limit=depth_wall())
    assert (ball > 0.01).float().mean() < 0.5 * (free > 0.01).float().mean()
    half = SIZE[1] // 2
    assert torch.equal(wall[:half], free[:half])
    assert (wall[half:] <= free[half:] + 1e-6).all()
    assert wall[half:].mean() < 0.9 * free[half:].mean()


TF_CASES = {
    "control points": lambda: JaxTF.from_control_points(
        color_points=[(0.0, (0.0, 0.2, 1.0)), (0.5, (0.1, 1.0, 0.1)),
                      (1.0, (1.0, 0.1, 0.0))],
        opacity_points=[(0.0, 0.0), (0.4, 0.3), (1.0, 0.9)]),
    "config 1 colormap": lambda: JaxTF.from_colormap(
        "coolwarm", domain=(-1, 1),
        opacity_points=((0.0, 0.8), (0.5, 0.0), (1.0, 0.8))),
    "points off 0 and 1, a repeated knot": lambda: JaxTF.from_control_points(
        color_points=[(0.1, (1.0, 0.0, 0.0)), (0.1, (0.0, 1.0, 0.0)),
                      (0.7, (0.0, 0.0, 1.0))],
        opacity_points=[(0.2, 0.5), (0.9, 0.1)]),
}


@pytest.mark.parametrize("case", list(TF_CASES))
def test_tf_hinges_match_jax(case):
    jtf = TF_CASES[case]()
    want_knots, want_slopes, want_base = rk.tf_hinges(jtf)
    knots, slopes, base = trk.tf_hinges(port_tf(jtf))
    k = len(knots)
    np.testing.assert_array_equal(knots, want_knots[:k])
    np.testing.assert_array_equal(slopes, want_slopes[:, :k])
    np.testing.assert_array_equal(base, want_base)
    # JAX pads to a multiple of 4 with inert knots the port leaves out.
    assert (want_knots[k:] == 2.0).all() and not want_slopes[:, k:].any()


def random_tf(seed):
    """Control points at random positions (some outside [0, 1], some
    shared by colour and opacity) with random values."""
    rng = np.random.default_rng(seed)
    xs = np.round(rng.uniform(-0.2, 1.2, size=7), 3)
    color = [(float(x), tuple(float(c) for c in rng.random(3)))
             for x in np.sort(xs[:4])]
    opacity = [(float(x), float(rng.random()))
               for x in np.sort(np.concatenate([xs[2:3], xs[4:]]))]
    return TransferFunction.from_control_points(color, opacity)


SEGMENT_CASES = {
    **{name: (lambda f=f: port_tf(f())) for name, f in TF_CASES.items()},
    **{f"colormap {name}": (lambda name=name: TransferFunction.from_colormap(
        name, opacity_points=((0.0, 0.1), (0.3, 0.0), (0.8, 0.6),
                              (1.0, 0.9))))
       for name in ("gray", "coolwarm", "viridis", "heatmap")},
    **{f"random {seed}": (lambda seed=seed: random_tf(seed))
       for seed in range(4)},
}


def segment_eval(knots, values, slopes, u):
    """B5's evaluation: the kernel's binary search over the knots padded
    to 32 slots with +inf, then one FMA a channel."""
    table = np.full(32, np.inf, np.float32)
    table[:len(knots)] = knots
    half = 1
    while half < len(knots):
        half *= 2
    out = []
    for uu in u:
        i, step = 0, half // 2
        while step > 0:
            if table[i + step] <= uu:
                i += step
            step //= 2
        h = np.float32(uu - knots[i])
        out.append((slopes[:, i].astype(np.float64) * h
                    + values[:, i]).astype(np.float32))
    return np.stack(out, axis=1)


def hinge_sum(knots, slopes, base, u):
    """The hinge sum of :func:`tf_hinges`'s float32 arrays, evaluated in
    float64 (B5's plain version runs it in float32, whose own rounding
    reaches 3e-6 on the random cases' steep segments)."""
    h = np.maximum(u[None, :].astype(np.float64)
                   - knots[:, None].astype(np.float64), 0.0)
    return base[:, None].astype(np.float64) + slopes.astype(np.float64) @ h


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_tf_segments_match_the_hinge_sum(case):
    tf = SEGMENT_CASES[case]()
    knots, values, slopes = trk.tf_segments(tf)
    h_knots, h_slopes, base = trk.tf_hinges(tf)
    np.testing.assert_array_equal(knots, h_knots)
    assert values.shape == slopes.shape == (4, len(knots))
    assert not slopes[:, -1].any()  # flat after the last knot
    inside = np.clip(knots, 0.0, 1.0)
    mids = np.clip((knots[:-1] + knots[1:]) / 2, 0.0, 1.0)
    u = np.concatenate([inside, mids, np.linspace(0.0, 1.0, 101),
                        np.nextafter(inside, np.float32(2.0)),
                        np.nextafter(inside, np.float32(-1.0))])
    u = np.clip(u.astype(np.float32), 0.0, 1.0)
    got = segment_eval(knots, values, slopes, u)
    want = hinge_sum(h_knots, h_slopes, base, u)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # The knot values are the function's (the LUT's control points).
    at_knots = (knots >= 0.0) & (knots <= 1.0)
    np.testing.assert_allclose(
        segment_eval(knots, values, slopes, knots[at_knots]),
        values[:, at_knots], atol=0, rtol=0)


def test_tf_hinges_refuse_a_lut_only_tf():
    with pytest.raises(trk.RaymarchUnsupported, match="control points"):
        trk.tf_hinges(TransferFunction(lut=torch.zeros((8, 4))))


PLAN_CASES = [
    dict(position=(0.0, 0.05, 0.62)),
    dict(position=(0.0, 0.05, -0.62)),
    dict(position=(0.6, 0.1, 0.1)),
    dict(position=(-0.5, 0.3, -0.2)),
    dict(position=(0.1, -0.8, 0.3), up=(0.0, 0.0, 1.0)),
    dict(position=(0.05, 0.3, 0.85)),  # config 1
    dict(position=(0.7, 0.6, 0.2)),
]


@pytest.mark.parametrize("cam_kw", PLAN_CASES)
@pytest.mark.parametrize("shape,size,model", [
    ((12, 14, 18), SIZE, None),
    ((250, 250, 250), (1920, 1080), None),
    ((32, 128, 128), (1280, 720), rotation_y(40.0)),
])
def test_plan_matches_jax(cam_kw, shape, size, model):
    jcam, tcam = cams(**cam_kw)
    want = rk.plan_raymarch(jcam, shape, size, model_matrix=model,
                            max_bu=10**6, max_bv=10**6)
    got = trk.plan_raymarch(tcam, shape, size, model_matrix=model)
    for key in ("axis_world", "flip", "lane_axis", "sub_axis", "planes",
                "sub_extent", "lane_extent"):
        assert got[key] == want[key], key
    for key in ("voxel", "box_min", "box_max", "m_rot", "m_trans"):
        np.testing.assert_array_equal(got[key], want[key])
    for step in (0.1, 0.25, 0.5, 1.0):
        assert (texact._q_from_voxel_step(got, step)
                == jexact._q_from_voxel_step(want, step))
    want_p = rk._common_params(want, jcam, 10)
    assert trk._common_params(got, tcam, 10) == want_p


def test_mixed_sign_camera_routes_to_dvr_render():
    # The JAX planner accepts this camera and renders the rays that run
    # against the principal axis as background (ADVICE #1); the port
    # refuses to plan it, and dvr_render_exact draws it with dvr_render.
    vol = make_volume()
    jcam, tcam = cams((0.5, 0.45, 0.05), fovy=np.deg2rad(150.0))
    rk.plan_raymarch(jcam, vol.shape, SIZE, max_bu=10**6, max_bv=10**6)
    with pytest.raises(trk.RaymarchUnsupported, match="mixed-sign"):
        trk.plan_raymarch(tcam, vol.shape, SIZE)
    jtf, ttf = tfs(vol)
    kw = dict(image_size=SIZE, voxel_step=0.5, attenuation=8.0)
    got = texact.dvr_render_exact(torch.from_numpy(vol), tcam, ttf, **kw)
    assert torch.equal(got, dvr_render(torch.from_numpy(vol), tcam, ttf,
                                       **kw))
    want = np.asarray(jax_dvr_render(jnp.asarray(vol), jcam, jtf, **kw))
    assert np.abs(got.numpy() - want).max() <= ATOL_DVR


def test_lut_only_tf_routes_to_dvr_render():
    # The JAX marcher substitutes a gray ramp for a TF without control
    # points; the port renders such a TF through its LUT with dvr_render.
    vol = make_volume()
    _, tcam = cams()
    _, ttf = tfs(vol)
    lut_only = TransferFunction(lut=ttf.lut, domain=ttf.domain)
    kw = dict(image_size=SIZE, voxel_step=0.5, attenuation=8.0)
    _build.reset_launch_counts()
    got = texact.dvr_render_exact(torch.from_numpy(vol), tcam, lut_only,
                                  **kw)
    assert torch.equal(got, dvr_render(torch.from_numpy(vol), tcam,
                                       lut_only, **kw))
    assert _build.LAUNCHES["raymarch_dvr"] == 0


EXACT_CASES = {
    "default": dict(),
    "flipped, background": dict(position=(0.0, 0.05, -0.62),
                                background=(0.1, 0.2, 0.3, 1.0)),
    "+x, step 0.25": dict(position=(0.6, 0.1, 0.1), voxel_step=0.25),
    "nan yellow": dict(with_nan=True, nan_mode="yellow"),
    "restriction": dict(restriction=((0.02, -0.01, 0.0), 0.12, "Chebyshev")),
    "depth limit": dict(depth_limit=True),
    "model matrix": dict(model_matrix=rotation_y(90.0)),
    "saturating": dict(attenuation=100.0),
}


@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_dvr_render_exact_matches_jax(case):
    kw = dict(EXACT_CASES[case])
    vol = make_volume(with_nan=kw.pop("with_nan", False))
    jcam, tcam = cams(kw.pop("position", (0.0, 0.05, 0.62)))
    jtf, ttf = tfs(vol)
    if kw.pop("depth_limit", False):
        kw["depth_limit"] = depth_wall()
    kw = dict(dict(image_size=SIZE, voxel_step=0.1, attenuation=10.0), **kw)
    # Below JAX's interpret-mode ceiling, or JAX would silently render
    # with dvr_render and this would compare the wrong renderers.
    jplan = rk.plan_raymarch(jcam, vol.shape, SIZE,
                             model_matrix=kw.get("model_matrix"))
    q = jexact._q_from_voxel_step(jplan, kw["voxel_step"])
    assert (SIZE[0] * SIZE[1] * (jplan["planes"] + 1) * q
            <= jexact._INTERPRET_MAX_SAMPLES)
    jkw = dict(kw)
    if "depth_limit" in jkw:
        jkw["depth_limit"] = jnp.asarray(jkw["depth_limit"])
    want = np.asarray(jexact.dvr_render_exact(jnp.asarray(vol), jcam, jtf,
                                              **jkw))
    prepared = texact.ExactPrepared(torch.from_numpy(vol))
    got = texact.dvr_render_exact(torch.from_numpy(vol), tcam, ttf,
                                  prepared=prepared, **kw).numpy()
    assert len(prepared._by_key) == 1  # it went through the marcher
    assert got.shape == (SIZE[1], SIZE[0], 4) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= ATOL_EXACT
    assert jmetrics.ssim(got, want) >= MIN_SSIM_EXACT


def test_exact_prepared_keeps_one_layout_per_axis():
    vol = torch.from_numpy(make_volume())
    _, ttf = tfs(vol.numpy())
    prep = texact.ExactPrepared(vol)
    for pos in ((0.0, 0.05, 0.62), (0.62, 0.05, 0.0), (0.0, 0.05, 0.7)):
        texact.dvr_render_exact(vol, cams(pos)[1], ttf, image_size=(16, 8),
                                voxel_step=0.5, prepared=prep)
    assert len(prep._by_key) == 2  # two principal-axis layouts


def test_unsupported_nan_mode_routes_to_dvr_render():
    vol = torch.from_numpy(make_volume(with_nan=True))
    _, tcam = cams()
    _, ttf = tfs(vol.numpy())
    kw = dict(image_size=(16, 8), voxel_step=0.5, nan_mode="other")
    assert torch.equal(texact.dvr_render_exact(vol, tcam, ttf, **kw),
                       dvr_render(vol, tcam, ttf, **kw))


def test_sample_trilinear_matches_jax():
    rng = np.random.default_rng(2)
    vol = rng.normal(size=(5, 6, 7)).astype(np.float32)
    vol[1, 2, 3] = np.nan
    coords = rng.uniform(-0.2, 1.2, size=(40, 30, 3)).astype(np.float32)
    want = np.asarray(jax_sample_trilinear(jnp.asarray(vol),
                                           jnp.asarray(coords)))
    got = sample_trilinear(torch.from_numpy(vol),
                           torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_ray_box_intersect_matches_jax():
    jcam, _ = cams((0.3, 0.2, 0.5))
    box = (np.array([-0.25, -0.2, -0.1], np.float32),
           np.array([0.25, 0.2, 0.1], np.float32))
    # The same rays for both (the cameras' rays agree to ~1 ulp, which
    # moves t a lot where a direction component is near zero).
    jo, jd = jcam.rays(48, 24)
    want = jax_ray_box_intersect(jo, jd, jnp.asarray(box[0]),
                                 jnp.asarray(box[1]))
    got = ray_box_intersect(torch.tensor(np.asarray(jo)),
                            torch.tensor(np.asarray(jd)),
                            torch.from_numpy(box[0]),
                            torch.from_numpy(box[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0.1 < got[2].float().mean() < 0.9
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


DVR_CASES = {
    "default": dict(),
    "eye inside": dict(position=(0.02, 0.01, 0.05),
                       look_at_point=(0.0, 0.0, -1.0)),
    "nan yellow": dict(with_nan=True, nan_mode="yellow"),
    "restriction": dict(restriction=((0.02, -0.01, 0.0), 0.12, "Euclidean")),
    "depth limit, model matrix": dict(depth_limit=True,
                                      model_matrix=rotation_y(30.0)),
}


@pytest.mark.parametrize("case", list(DVR_CASES))
def test_dvr_render_matches_jax(case):
    kw = dict(DVR_CASES[case])
    vol = make_volume(with_nan=kw.pop("with_nan", False))
    jcam, tcam = cams(kw.pop("position", (0.0, 0.05, 0.62)),
                      **({"look_at_point": kw.pop("look_at_point")}
                         if "look_at_point" in kw else {}))
    jtf, ttf = tfs(vol)
    if kw.pop("depth_limit", False):
        kw["depth_limit"] = depth_wall()
    kw = dict(dict(image_size=SIZE, voxel_step=0.25, attenuation=10.0,
                   background=(0.1, 0.2, 0.3, 0.0)), **kw)
    want = np.asarray(jax_dvr_render(jnp.asarray(vol), jcam, jtf, **kw))
    got = dvr_render(torch.from_numpy(vol), tcam, ttf, **kw).numpy()
    assert np.abs(got - want).max() <= ATOL_DVR
    assert 0.01 < got[..., 3].mean() < 0.95  # neither empty nor opaque


def test_render_correlation_matches_jax():
    data = jfixtures.synth_box_ensemble(xs=16, ys=12, zs=8, members=30)
    stack = np.ascontiguousarray(np.moveaxis(data, 0, -1))
    jcam, tcam = cams((0.05, 0.3, 0.85))
    jtf = JaxTF.from_colormap("coolwarm", domain=(-1, 1),
                              opacity_points=((0.0, 0.8), (0.5, 0.0),
                                              (1.0, 0.8)))
    kw = dict(image_size=(48, 32), voxel_step=0.25)
    want = np.asarray(jax_render_correlation(jnp.asarray(stack), (8, 6, 4),
                                             jcam, jtf, **kw))
    # Leave the JAX package's fused-program cache as this test found it:
    # tests/test_recompile_guard.py counts its entries in the same worker.
    jax_pipeline._fused.clear_cache()
    got = render_correlation(stack_from_numpy(stack), (8, 6, 4), tcam,
                             port_tf(jtf), **kw).numpy()
    # The Pearson fields agree to ~1e-7 (test_torch_port_pearson.py); the
    # march adds its own summation-order differences.
    assert np.abs(got - want).max() <= ATOL_DVR
    assert got[..., :3].max() > 0.2
