"""PyTorch port (correrender_tpu_torch) vs the JAX package: the whole
config-1 slice (reference series → Pearson field → shear-warp DVR), its
eye-inside, depth-clipped and pre-classified branches, and the port's
independence from JAX.

On the CPU every kernel wrapper runs its plain version; chip_smoke.py
holds the kernels to those on the card.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from correrender_tpu.render import Camera as JaxCamera
from correrender_tpu.render import TransferFunction as JaxTF
from correrender_tpu.render.dvr_fast import dvr_shearwarp as jax_dvr
from correrender_tpu.render.pipeline import (
    render_correlation_fast as jax_render_fast,
)
from correrender_tpu.utils import fixtures as jfixtures
from correrender_tpu.utils import metrics as jmetrics

from correrender_tpu_torch.app import baseline_configs
from correrender_tpu_torch.interop import (
    camera_from_fields,
    stack_from_numpy,
    transfer_function_from_arrays,
)
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.render.dvr_fast import (
    _gather_warp,
    dvr_shearwarp,
    prepare_shearwarp,
    shearwarp_axes,
)
from correrender_tpu_torch.render.pipeline import (
    reference_series,
    render_correlation_fast,
)
from correrender_tpu_torch.utils import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (24, 20, 12)  # (xs, ys, zs)
MEMBERS = 40
IMAGE = (96, 64)
MAX_ABS = 1e-2
MIN_SSIM = 0.995


@pytest.fixture(scope="module")
def config1():
    """Config 1's ensemble, camera and TF, as numpy state for both."""
    xs, ys, zs = GRID
    data = jfixtures.synth_box_ensemble(xs=xs, ys=ys, zs=zs,
                                        members=MEMBERS)
    stack = np.ascontiguousarray(np.moveaxis(data, 0, -1))
    jcam = JaxCamera(position=(0.05, 0.3, 0.85))
    jtf = JaxTF.from_colormap(
        "coolwarm", domain=(-1, 1),
        opacity_points=((0.0, 0.8), (0.5, 0.0), (1.0, 0.8)),
    )
    tcam = camera_from_fields(jcam.position, jcam.look_at_point, jcam.up,
                              jcam.fovy, jcam.z_near, jcam.z_far)
    ttf = transfer_function_from_arrays(np.asarray(jtf.lut), jtf.domain)
    return stack, (jcam, jtf), (tcam, ttf)


@pytest.mark.parametrize("ref_point", [(12, 10, 6), (5, 4, 6)])
def test_render_correlation_fast_matches_jax(config1, ref_point):
    stack, (jcam, jtf), (tcam, ttf) = config1
    want = np.asarray(jax_render_fast(jnp.asarray(stack), ref_point, jcam,
                                      jtf, "pearson", image_size=IMAGE))
    got = render_correlation_fast(stack_from_numpy(stack), ref_point, tcam,
                                  ttf, "pearson", image_size=IMAGE).numpy()
    assert got.shape == (IMAGE[1], IMAGE[0], 4) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= MAX_ABS
    assert jmetrics.ssim(got, want) >= MIN_SSIM
    # The frame is not empty: the planted boxes show against the
    # black background.
    assert got[..., :3].max() > 0.2


CAMERA_VARIANTS = [
    dict(position=(0.9, 0.15, -0.2)),  # x axis
    dict(position=(-0.85, 0.2, 0.1)),  # x axis, reversed slice order
    dict(position=(0.1, -0.8, 0.3), up=(0.0, 0.0, 1.0)),  # y axis
    dict(position=(-0.2, 0.1, -0.9)),  # z axis, no flip
]


@pytest.mark.parametrize("cam_kw", CAMERA_VARIANTS)
def test_dvr_shearwarp_matches_jax_for_every_slice_orientation(cam_kw):
    rng = np.random.default_rng(7)
    field = rng.uniform(-1, 1, size=(10, 14, 18)).astype(np.float32)
    field[2, 3, 4] = np.nan
    jcam = JaxCamera(**cam_kw)
    tcam = camera_from_fields(jcam.position, jcam.look_at_point, jcam.up,
                              jcam.fovy, jcam.z_near, jcam.z_far)
    jtf = JaxTF.from_colormap("viridis", domain=(-1, 1),
                              opacity_points=((0.0, 0.6), (1.0, 0.2)))
    ttf = transfer_function_from_arrays(np.asarray(jtf.lut), jtf.domain)
    kw = dict(image_size=(80, 60), intermediate_scale=0.75,
              background=(0.2, 0.1, 0.0, 1.0))
    want = np.asarray(jax_dvr(jnp.asarray(field), jcam, jtf, **kw))
    got = dvr_shearwarp(torch.from_numpy(field), tcam, ttf, **kw).numpy()
    assert np.abs(got - want).max() <= MAX_ABS
    assert jmetrics.ssim(got, want) >= MIN_SSIM


def test_prepared_layout_is_reused_and_rebuilt(config1):
    _, _, (tcam, ttf) = config1
    field = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, size=(12, 20, 24)).astype(np.float32))
    direct = dvr_shearwarp(field, tcam, ttf, image_size=IMAGE)
    prep = prepare_shearwarp(field, ttf, tcam)
    assert prep["key"] == (2, True) and prep["cf"].shape == (12, 20, 24, 4)
    assert torch.equal(dvr_shearwarp(field, tcam, ttf, image_size=IMAGE,
                                     prepared=prep), direct)
    side = Camera(position=(0.9, 0.15, -0.2))  # another principal axis
    assert torch.equal(
        dvr_shearwarp(field, side, ttf, image_size=IMAGE, prepared=prep),
        dvr_shearwarp(field, side, ttf, image_size=IMAGE))


def test_gather_warp_agrees_with_matmul_warp(config1):
    # The gather warp is warp_to_screen's fallback when no two-pass
    # factorization is valid; held here to the matmul warp on the same
    # intermediate image.
    _, _, (tcam, ttf) = config1
    field = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, size=(12, 20, 24)).astype(np.float32))
    stages = {}
    a = dvr_shearwarp(field, tcam, ttf, image_size=IMAGE,
                      on_stage=stages.__setitem__)
    rgb, alpha, geo = stages["composite"]
    _, axis, in_plane, _ = shearwarp_axes(tcam)
    b = _gather_warp(rgb, alpha, tcam, IMAGE[0], IMAGE[1], in_plane, axis,
                     geo["z_ref"], geo["grid_u"], geo["grid_v"],
                     (0.0, 0.0, 0.0, 1.0))
    assert tmetrics.ssim(a.numpy(), b.numpy()) > 0.98


def test_stage_hook_reports_the_main_path(config1):
    stack, _, (tcam, ttf) = config1
    stages = {}
    img = render_correlation_fast(stack_from_numpy(stack), (12, 10, 6), tcam,
                                  ttf, image_size=IMAGE,
                                  on_stage=stages.__setitem__)
    assert list(stages) == ["field", "classify", "composite", "warp"]
    assert stages["field"].shape == stack.shape[:-1]
    assert stages["classify"]["cf"].shape == stack.shape[:-1] + (4,)
    assert stages["composite"][1].shape == (stages["composite"][2]["hi_res"],
                                            stages["composite"][2]["wi_res"])
    assert stages["warp"] is img
    assert torch.equal(img, render_correlation_fast(
        stack_from_numpy(stack), (12, 10, 6), tcam, ttf, image_size=IMAGE))


@pytest.mark.parametrize("caller_tf32", [True, False])
def test_warp_leaves_the_callers_tf32_setting(config1, caller_tf32):
    _, _, (tcam, ttf) = config1
    field = torch.zeros((12, 20, 24))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = caller_tf32
    try:
        dvr_shearwarp(field, tcam, ttf, image_size=IMAGE)
        assert torch.backends.cuda.matmul.allow_tf32 is caller_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_tensor_reference_point_matches_host_ints(config1):
    stack = stack_from_numpy(config1[0])
    got = reference_series(stack, torch.tensor([5, 4, 6]))
    assert torch.equal(got, stack[6, 4, 5])


# The next three tests began as pins of branches the first slice left
# out; those branches are ported now, and each test holds its branch to
# the JAX package.


def _field_and_cams(config1, **cam_kw):
    _, (jcam, jtf), (tcam, ttf) = config1
    if cam_kw:
        jcam = JaxCamera(**cam_kw)
        tcam = camera_from_fields(jcam.position, jcam.look_at_point, jcam.up,
                                  jcam.fovy, jcam.z_near, jcam.z_far)
    field = np.random.default_rng(8).uniform(
        -1, 1, size=(12, 20, 24)).astype(np.float32)
    return field, (jcam, jtf), (tcam, ttf)


def test_non_viable_camera_is_stubbed(config1):
    # An eye inside the volume's slab renders with the fixed-step marcher.
    field, (jcam, jtf), (tcam, ttf) = _field_and_cams(
        config1, position=(0.0, 0.0, 0.01), look_at_point=(0.0, 0.0, -1.0))
    kw = dict(image_size=(48, 32), attenuation=20.0)
    want = np.asarray(jax_dvr(jnp.asarray(field), jcam, jtf, **kw))
    got = dvr_shearwarp(torch.from_numpy(field), tcam, ttf, **kw).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert got[..., :3].max() > 0.05


def test_depth_limit_is_stubbed(config1):
    field, (jcam, jtf), (tcam, ttf) = _field_and_cams(config1)
    depth = np.full((IMAGE[1], IMAGE[0]), np.inf, np.float32)
    depth[:, IMAGE[0] // 2:] = 0.9  # a wall through the right half
    want = np.asarray(jax_dvr(jnp.asarray(field), jcam, jtf,
                              image_size=IMAGE,
                              depth_limit=jnp.asarray(depth)))
    got = dvr_shearwarp(torch.from_numpy(field), tcam, ttf, image_size=IMAGE,
                        depth_limit=depth).numpy()
    assert np.abs(got - want).max() <= MAX_ABS
    assert jmetrics.ssim(got, want) >= MIN_SSIM
    free = dvr_shearwarp(torch.from_numpy(field), tcam, ttf,
                         image_size=IMAGE).numpy()
    assert np.abs(got - free)[:, IMAGE[0] // 2:].max() > 0.05


def test_classified_volume_is_stubbed(config1):
    field, (jcam, jtf), (tcam, ttf) = _field_and_cams(config1)
    cls = np.random.default_rng(9).uniform(
        0, 0.4, size=field.shape + (4,)).astype(np.float32)
    want = np.asarray(jax_dvr(jnp.asarray(field), jcam, jtf,
                              image_size=IMAGE,
                              classified=jnp.asarray(cls)))
    got = dvr_shearwarp(torch.from_numpy(field), tcam, ttf, image_size=IMAGE,
                        classified=torch.from_numpy(cls)).numpy()
    assert np.abs(got - want).max() <= MAX_ABS
    assert jmetrics.ssim(got, want) >= MIN_SSIM


def test_other_measures_are_stubbed_on_the_main_path(config1):
    # Began as a pin of the stub; the rank measures are ported now and the
    # frame is held to the JAX package's.
    stack, (jcam, jtf), (tcam, ttf) = config1
    want = np.asarray(jax_render_fast(jnp.asarray(stack), (12, 10, 6), jcam,
                                      jtf, "spearman", image_size=IMAGE))
    got = render_correlation_fast(stack_from_numpy(stack), (12, 10, 6), tcam,
                                  ttf, "spearman", image_size=IMAGE).numpy()
    assert np.abs(got - want).max() <= MAX_ABS
    assert jmetrics.ssim(got, want) >= MIN_SSIM
    assert got[..., :3].max() > 0.2


def test_measure_kwargs_reach_the_field(config1):
    stack, _, (tcam, ttf) = config1
    stages = {}
    render_correlation_fast(stack_from_numpy(stack), (12, 10, 6), tcam, ttf,
                            "mi_kraskov", image_size=IMAGE, k=4,
                            kraskov_estimator=2, on_stage=stages.__setitem__)
    from correrender_tpu_torch.calculators.correlation import correlate_field

    stack_t = stack_from_numpy(stack)
    want = correlate_field(stack_t, reference_series(stack_t, (12, 10, 6)),
                           "mi_kraskov", k=4, kraskov_estimator=2)
    assert torch.equal(stages["field"], want)


def test_config1_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        baseline_configs.config1_synth_box_pearson_dvr(device="cpu")


def test_config1_state_matches_jax_config():
    jtf = JaxTF.from_colormap(
        "coolwarm", domain=(-1, 1),
        opacity_points=((0.0, 0.8), (0.5, 0.0), (1.0, 0.8)))
    ttf = baseline_configs.config1_transfer_function()
    np.testing.assert_array_equal(ttf.lut.numpy(), np.asarray(jtf.lut))
    assert baseline_configs.config1_camera().position == (0.05, 0.3, 0.85)


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(size=(30, 40, 4))
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1)
    assert tmetrics.ssim(a, b) == pytest.approx(jmetrics.ssim(a, b),
                                                rel=1e-12)
    assert tmetrics.psnr(a, b) == pytest.approx(jmetrics.psnr(a, b))
    assert tmetrics.mse(a, b) == pytest.approx(jmetrics.mse(a, b))
    assert tmetrics.psnr(a, a) == float("inf")


def _run(code, cwd=REPO):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_port_never_imports_jax():
    # In a fresh interpreter: tests/conftest.py imports jax in this one.
    proc = _run("""
        import pkgutil, sys
        import numpy as np, torch
        import correrender_tpu_torch
        for mod in pkgutil.walk_packages(correrender_tpu_torch.__path__,
                                         "correrender_tpu_torch."):
            __import__(mod.name)
        for name in ("ops.dkl", "ops.similarity", "ops.precision",
                     "calculators.ensemble",
                     "calculators.binop", "calculators.noise",
                     "calculators.set_predicate",
                     "calculators.residual_color", "calculators.velocity",
                     "calculators.dkl_calculator", "parallel.mesh",
                     "parallel.pearson_sharded", "parallel.halo",
                     "parallel.dvr_sharded", "io.writers"):
            assert "correrender_tpu_torch." + name in sys.modules, name
        from correrender_tpu_torch.app.baseline_configs import (
            config1_camera, config1_transfer_function)
        from correrender_tpu_torch.render.pipeline import (
            render_correlation_fast)
        from correrender_tpu_torch.utils.fixtures import synth_box_stack
        stack = synth_box_stack(8, 8, 4, 12, torch.Generator().manual_seed(0))
        img = render_correlation_fast(stack, (2, 2, 2), config1_camera(),
                                      config1_transfer_function(),
                                      image_size=(32, 24))
        assert img.shape == (24, 32, 4) and bool(torch.isfinite(img).all())
        # One /frame through the viewer's server.
        import threading, urllib.request
        from correrender_tpu_torch.app.state import Scene
        from correrender_tpu_torch.app.viewer import make_server
        from correrender_tpu_torch.calculators.correlation import (
            CorrelationCalculator)
        from correrender_tpu_torch.core.fields import (
            GridMetadata, VolumeData)
        vd = VolumeData(GridMetadata(xs=8, ys=8, zs=4, es=12), device="cpu")
        vd.add_field("q", lambda t, e: stack[..., e])
        scene = Scene(vd, [config1_camera()])
        scene.add_renderer("dvr", field=scene.add_calculator(
            CorrelationCalculator("q", reference_point=(2, 2, 2))))
        server, app = make_server(scene, port=0, image_size=(32, 24))
        thread = threading.Thread(target=server.serve_forever)
        thread.start()
        url = "http://%s:%d/frame" % server.server_address
        with urllib.request.urlopen(url, timeout=60) as r:
            assert r.status == 200 and r.read()[:4] == b"\\x89PNG"
        server.shutdown()
        server.server_close()
        thread.join()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "correrender_tpu"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout


def _assert_smoke_refused(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_without_cuda():
    # This host has no CUDA device, so the smoke run must fail at once.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _assert_smoke_refused(subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=120))


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        (tmp_path / "chip_smoke.py").write_text(src.read())
    _assert_smoke_refused(subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ""}))
