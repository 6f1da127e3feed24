"""PyTorch port (``correrender_tpu_torch``) vs the JAX package: transfer-
function optimization (``optim/solvers.py``, ``optim/tf_opt.py``).

The same seeded numpy inputs go through both packages: the JAX tests'
120×30 least-squares system and ``_paired_fields`` (``field_b`` a
monotone remap of ``field_a``). Bars: the direct solvers within 1e-5 of
JAX's solution relative to its largest entry, the iterative ones 1e-4;
the normal equations 1e-5 relative; the fitted OLS and GD LUTs 1e-4.

DiffDVR is held by paired steps, not trajectories: from one shared LUT,
the gradient through the marcher within 1e-5 of ``jax.grad``'s relative
to its largest entry, and one Adam epoch within 1e-6 of JAX's compiled
epoch loop run for one epoch. A 30-epoch fit more than halves the image
error, as ``tests/test_optim.py`` requires of JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from correrender_tpu.optim import solvers as jax_solvers
from correrender_tpu.optim import tf_opt as jax_tf_opt
from correrender_tpu.render import Camera as JaxCamera
from correrender_tpu.render import TransferFunction as JaxTF
from correrender_tpu.render.dvr import dvr_render as jax_dvr_render

from correrender_tpu_torch.optim import (
    TFOptimizationWorker,
    TFOptimizer,
    cgls,
    lsqr,
    optimize_tf_diffdvr,
    optimize_tf_gd,
    optimize_tf_ols,
    solve_nonneg,
    tf_opt,
)
from correrender_tpu_torch.optim.solvers import solve_dense
from correrender_tpu_torch.render.camera import Camera
from correrender_tpu_torch.render.classify import classify
from correrender_tpu_torch.render.dvr import dvr_render
from correrender_tpu_torch.render.tf import TransferFunction

DIRECT = 1e-5
ITERATIVE = 1e-4
LUT = 1e-4


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def system():
    """The JAX tests' system: A (120, 30), x uniform, b = A x."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(120, 30)).astype(np.float32)
    x_true = rng.uniform(size=30).astype(np.float32)
    b = np.asarray(jnp.asarray(a) @ jnp.asarray(x_true))
    return a, x_true, b


def _paired_fields(n=16):
    """field_b is a monotone remap of field_a: an exact TF exists."""
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(n, n, n)).astype(np.float32)
    return a, np.sqrt(a)


def _tfs():
    kw = dict(domain=(0.0, 1.0), opacity_points=((0.0, 0.1), (1.0, 0.9)))
    return (JaxTF.from_colormap("viridis", **kw),
            TransferFunction.from_colormap("viridis", device="cpu", **kw))


def _voxel_match_error(field_a, tf_a, field_b, tf_b):
    want = classify(t(field_a).reshape(-1), tf_a.lut, tf_a.domain,
                    premultiply=False)
    got = classify(t(field_b).reshape(-1), tf_b.lut, tf_b.domain,
                   premultiply=False)
    return float((got - want).abs().mean())


def _empty_bin_system(tf_size=32):
    """Normal equations whose upper bins hold no voxel (field B fills
    only the lower half of its domain): AᵀA has zero rows there."""
    a, b = _paired_fields(8)
    jtf, _ = _tfs()
    domain = (0.0, 2.0 * float(b.max()))
    ata, atb, _ = jax_tf_opt._normal_equations(
        jnp.asarray(a).ravel(), jnp.asarray(b).ravel(), jtf, domain,
        tf_size)
    ata, atb = np.asarray(ata), np.asarray(atb)
    assert (np.diag(ata)[tf_size // 2 + 1:] == 0).all()
    return ata, atb


# -- solvers -----------------------------------------------------------------

def test_cgls_matches_jax(system):
    a, x_true, b = system
    want = np.asarray(jax_solvers.cgls(jnp.asarray(a), jnp.asarray(b),
                                       iters=60))
    got = cgls(t(a), t(b), iters=60).numpy()
    assert rel(got, want) <= ITERATIVE
    np.testing.assert_allclose(got, x_true, atol=1e-3)


def test_lsqr_matches_jax(system):
    a, x_true, b = system
    want = np.asarray(jax_solvers.lsqr(jnp.asarray(a), jnp.asarray(b),
                                       iters=60))
    got = lsqr(t(a), t(b), iters=60).numpy()
    assert rel(got, want) <= ITERATIVE
    np.testing.assert_allclose(got, x_true, atol=1e-3)


@pytest.mark.parametrize("method", ["lu", "cholesky", "qr", "svd"])
def test_dense_matches_jax(system, method):
    a, _, b = system
    ata = np.asarray(jnp.asarray(a).T @ jnp.asarray(a))
    atb = np.asarray(jnp.asarray(a).T @ jnp.asarray(b))
    want = np.asarray(jax_solvers.solve_dense(jnp.asarray(ata),
                                              jnp.asarray(atb), method))
    got = solve_dense(t(ata), t(atb), method).numpy()
    assert rel(got, want) <= DIRECT


@pytest.mark.parametrize("method", ["lu", "cholesky", "qr"])
def test_dense_with_empty_bins_matches_jax(method):
    ata, atb = _empty_bin_system()
    want = np.asarray(jax_solvers.solve_dense(jnp.asarray(ata),
                                              jnp.asarray(atb), method))
    got = solve_dense(t(ata), t(atb), method).numpy()
    assert got.shape == want.shape == atb.shape
    assert rel(got, want) <= DIRECT


def test_svd_with_empty_bins_drops_them_as_jax():
    """The SVD solve keeps the singular values JAX's lstsq keeps (the
    empty bins' 1e-8 fall under the cutoff, so their LUT rows are 0).
    The populated block's condition number κ (about 820 here) bounds what
    a float32 SVD solve can agree on: JAX's (LAPACK through XLA) and the
    port's (torch's LAPACK) each lie within 2·eps·κ of the float64
    minimum-norm solution, so within 4·eps·κ of each other (2.2e-4 apart
    here, where the Cholesky solves agree to 1e-7)."""
    ata, atb = _empty_bin_system()
    n = ata.shape[0]
    reg = ata.astype(np.float64) + 1e-8 * np.eye(n)
    sv = np.linalg.svd(reg, compute_uv=False)
    kept = sv >= np.finfo(np.float32).eps * n * sv[0]
    kappa = sv[0] / sv[kept].min()
    exact = np.linalg.lstsq(reg, atb.astype(np.float64),
                            rcond=np.finfo(np.float32).eps * n)[0]
    want = np.asarray(jax_solvers.solve_dense(jnp.asarray(ata),
                                              jnp.asarray(atb), "svd"))
    got = solve_dense(t(ata), t(atb), "svd").numpy()
    eps = np.finfo(np.float32).eps
    empty = np.diag(ata) == 0
    assert (got[empty] == 0).all() and (want[empty] == 0).all()
    assert rel(want, exact) <= 2 * eps * kappa
    assert rel(got, exact) <= 2 * eps * kappa
    assert rel(got, want) <= 4 * eps * kappa


def test_svd_keeps_jaxs_cutoff():
    """A rank-deficient system: JAX's lstsq drops singular values below
    eps·max(M, N)·σ_max, so the solution is the minimum-norm one."""
    m = np.diag(np.array([2.0, 1.0, 0.0], np.float32))
    rhs = np.array([2.0, 3.0, 5.0], np.float32)
    reg_free = m - 1e-8 * np.eye(3, dtype=np.float32)  # cancel solve's reg
    want = np.asarray(jax_solvers.solve_dense(jnp.asarray(reg_free),
                                              jnp.asarray(rhs), "svd"))
    got = solve_dense(t(reg_free), t(rhs), "svd").numpy()
    np.testing.assert_allclose(got, want, rtol=DIRECT)
    assert got[2] == 0.0


def test_unknown_dense_solver_raises(system):
    a, _, b = system
    with pytest.raises(ValueError, match="dense solver"):
        solve_dense(t(a.T @ a), t(a.T @ b), "cg")


@pytest.mark.parametrize("which", ["system", "empty_bins"])
def test_nonneg_matches_jax(system, which):
    if which == "system":
        a, _, b = system
        ata, atb = a.T @ a, a.T @ b
    else:
        ata, atb = _empty_bin_system()
        atb = atb[:, 3]
    want = np.asarray(jax_solvers.solve_nonneg(jnp.asarray(ata),
                                               jnp.asarray(atb), iters=500))
    got = solve_nonneg(t(ata), t(atb), iters=500).numpy()
    assert (got >= 0).all()
    assert rel(got, want) <= ITERATIVE


# -- OLS and GD ----------------------------------------------------------------

def test_normal_equations_match_jax():
    a, b = _paired_fields(8)
    jtf, ttf = _tfs()
    domain = (float(b.min()), float(b.max()))
    want = jax_tf_opt._normal_equations(jnp.asarray(a).ravel(),
                                        jnp.asarray(b).ravel(), jtf, domain,
                                        32)
    got = tf_opt._normal_equations(t(a).ravel(), t(b).ravel(), ttf, domain,
                                   32)
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) <= 1e-5


@pytest.mark.parametrize("solver", ["cholesky", "lu", "qr", "svd", "cgls",
                                    "lsqr"])
@pytest.mark.parametrize("nonneg", [True, False])
def test_ols_lut_matches_jax(solver, nonneg):
    a, b = _paired_fields(8)
    jtf, ttf = _tfs()
    want = jax_tf_opt.optimize_tf_ols(jnp.asarray(a), jtf, jnp.asarray(b),
                                      tf_size=32, solver=solver,
                                      nonneg=nonneg)
    got = optimize_tf_ols(t(a), ttf, t(b), tf_size=32, solver=solver,
                          nonneg=nonneg)
    assert got.domain == tuple(want.domain)
    assert np.abs(got.lut.numpy() - np.asarray(want.lut)).max() <= LUT
    assert _voxel_match_error(a, ttf, b, got) < 0.05


def test_ols_recovers_remapped_tf():
    a, b = _paired_fields()
    _, ttf = _tfs()
    tf_b = optimize_tf_ols(t(a), ttf, t(b), tf_size=64)
    assert _voxel_match_error(a, ttf, b, tf_b) < 0.02
    lut = tf_b.lut.numpy()
    assert (lut >= 0).all() and (lut <= 1).all()


@pytest.mark.parametrize("solver", ["cholesky", "cgls"])
def test_slab_accumulation_matches_single_shot(monkeypatch, solver):
    """Past the dense-weight budget the normal equations accumulate in
    voxel slabs (and cgls runs on them): the fit is the single-shot one,
    and JAX's under the same budget."""
    a, b = _paired_fields(8)
    jtf, ttf = _tfs()
    one = optimize_tf_ols(t(a), ttf, t(b), tf_size=32, solver=solver,
                          nonneg=False)
    monkeypatch.setattr(tf_opt, "_DENSE_WEIGHT_ELEMS", 2048)
    monkeypatch.setattr(jax_tf_opt, "_DENSE_WEIGHT_ELEMS", 2048)
    slabbed = optimize_tf_ols(t(a), ttf, t(b), tf_size=32, solver=solver,
                              nonneg=False)
    want = jax_tf_opt.optimize_tf_ols(jnp.asarray(a), jtf, jnp.asarray(b),
                                      tf_size=32, solver=solver,
                                      nonneg=False)
    assert np.abs(slabbed.lut.numpy() - np.asarray(want.lut)).max() <= LUT
    if solver == "cholesky":
        np.testing.assert_allclose(one.lut.numpy(), slabbed.lut.numpy(),
                                   atol=2e-5)
    assert _voxel_match_error(a, ttf, b, slabbed) < 0.05


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_gd_lut_matches_jax(optimizer):
    a, b = _paired_fields(12)
    jtf, ttf = _tfs()
    want = jax_tf_opt.optimize_tf_gd(jnp.asarray(a), jtf, jnp.asarray(b),
                                     tf_size=32, epochs=300,
                                     optimizer=optimizer)
    got = optimize_tf_gd(t(a), ttf, t(b), tf_size=32, epochs=300,
                         optimizer=optimizer)
    assert np.abs(got.lut.numpy() - np.asarray(want.lut)).max() <= LUT
    if optimizer == "adam":
        assert _voxel_match_error(a, ttf, b, got) < 0.05


def test_constant_field_b_yields_finite_lut():
    a, _ = _paired_fields(8)
    b = np.zeros_like(a)
    _, ttf = _tfs()
    for fit in (optimize_tf_ols, optimize_tf_gd):
        tf_b = fit(t(a), ttf, t(b), tf_size=16)
        assert torch.isfinite(tf_b.lut).all(), fit.__name__


def test_nan_in_field_b_is_ignored_by_the_domain():
    a, b = _paired_fields(8)
    b = b.copy()
    b[0, 0, :3] = np.nan
    jtf, ttf = _tfs()
    want = jax_tf_opt.optimize_tf_ols(jnp.asarray(a), jtf, jnp.asarray(b),
                                      tf_size=16)
    got = optimize_tf_ols(t(a), ttf, t(b), tf_size=16)
    assert got.domain == tuple(want.domain)
    assert np.abs(got.lut.numpy() - np.asarray(want.lut)).max() <= LUT


def test_unknown_optimizer_and_loss_raise():
    a, b = _paired_fields(6)
    _, ttf = _tfs()
    with pytest.raises(ValueError, match="optimizer"):
        optimize_tf_gd(t(a), ttf, t(b), tf_size=8, optimizer="Adam")
    with pytest.raises(ValueError, match="loss"):
        optimize_tf_diffdvr(t(a), ttf, t(b), Camera(position=(0.1, 0.2, 0.9)),
                            tf_size=8, loss="L1")


# -- DiffDVR -------------------------------------------------------------------

IMAGE = (32, 32)
POSITION = (0.0, 0.1, 0.8)


@pytest.fixture(scope="module")
def diffdvr_case():
    a, b = _paired_fields(12)
    jtf, ttf = _tfs()
    jcam, tcam = JaxCamera(position=POSITION), Camera(position=POSITION)
    jtarget = jax_dvr_render(jnp.asarray(a), jcam, jtf, image_size=IMAGE)
    ttarget = dvr_render(t(a), tcam, ttf, image_size=IMAGE)
    assert np.abs(ttarget.numpy() - np.asarray(jtarget)).max() <= 1e-5
    domain = (float(b.min()), float(b.max()))
    lut0 = np.random.default_rng(5).uniform(0.1, 0.9, (16, 4)).astype(
        np.float32)
    return dict(a=a, b=b, jtf=jtf, ttf=ttf, jcam=jcam, tcam=tcam,
                jtarget=jtarget, ttarget=ttarget, domain=domain, lut0=lut0)


def _jax_grad(c, loss, smoothing_weight=1e-3):
    """JAX's DiffDVR loss (``tf_opt.py:262-274``) and its ``jax.grad``."""
    domain = jnp.asarray(c["domain"], jnp.float32)

    def loss_fn(lut):
        img = jax_dvr_render(jnp.asarray(c["b"]), c["jcam"],
                             JaxTF(lut=lut, domain=domain),
                             image_size=IMAGE, attenuation=100.0)
        diff = img - c["jtarget"]
        data = (jnp.mean(jnp.abs(diff)) if loss == "l1"
                else jnp.mean(diff ** 2))
        return data + smoothing_weight * jnp.mean((lut[1:] - lut[:-1]) ** 2)

    return jax.value_and_grad(loss_fn)(jnp.asarray(c["lut0"]))


@pytest.mark.parametrize("loss", ["l2", "l1"])
def test_diffdvr_gradient_matches_jax_grad(diffdvr_case, loss):
    c = diffdvr_case
    want_loss, want = _jax_grad(c, loss)
    got_loss, got = tf_opt.diffdvr_grad(
        t(c["lut0"]), t(c["b"]), c["ttarget"], c["tcam"], c["domain"],
        IMAGE, loss)
    assert rel(got.numpy(), want) <= 1e-5
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * float(want_loss)


def test_diffdvr_adam_epoch_matches_jax(diffdvr_case):
    """One epoch from the shared LUT: JAX's compiled loop run for one
    epoch against the port's gradient and hand-written Adam step."""
    c = diffdvr_case
    run = jax_tf_opt._diffdvr_program(c["jcam"], IMAGE, "l2", 100.0, 1)
    want = run(jnp.asarray(c["b"]), c["jtarget"], jnp.asarray(c["lut0"]),
               jnp.asarray(c["domain"], jnp.float32), jnp.float32(0.1),
               jnp.float32(1e-3))
    _, g = tf_opt.diffdvr_grad(t(c["lut0"]), t(c["b"]), c["ttarget"],
                               c["tcam"], c["domain"], IMAGE)
    zeros = torch.zeros(16, 4)
    got, m, v = tf_opt.adam_step(t(c["lut0"]), g, zeros, zeros, 1, 0.1)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6
    assert torch.equal(m, 0.1 * g) and torch.equal(v, 0.001 * g * g)


def test_diffdvr_gradient_reaches_every_bin_the_field_reaches(diffdvr_case):
    """Nothing on the path leaves the graph: without the smoothing term a
    LUT entry gets a gradient exactly where one of the marcher's active
    samples interpolates from it. ``jax.grad`` of JAX's marcher marks
    those entries; the port's gradient is non-zero in each of them and
    zero elsewhere."""
    c = diffdvr_case
    _, want = _jax_grad(c, "l2", smoothing_weight=0.0)
    _, g = tf_opt.diffdvr_grad(t(c["lut0"]), t(c["b"]), c["ttarget"],
                               c["tcam"], c["domain"], IMAGE,
                               smoothing_weight=0.0)
    reached = np.asarray(want) != 0
    assert reached.any(axis=1).sum() >= 14  # bin 0 holds the minimum only
    np.testing.assert_array_equal(g.numpy() != 0, reached)


def test_diffdvr_fit_halves_the_image_error(diffdvr_case):
    c = diffdvr_case
    target = c["ttarget"]
    tf_b_domain = c["domain"]
    losses, luts = [], []

    def on_epoch(i, value, lut, grad):
        losses.append(float(value))
        luts.append(lut)
        if i == 0:  # the first gradient, at the start LUT
            _, g = tf_opt.diffdvr_grad(lut, t(c["b"]), target, c["tcam"],
                                       tf_b_domain, IMAGE)
            assert torch.equal(grad, g)

    tf_b = optimize_tf_diffdvr(
        t(c["a"]), c["ttf"], t(c["b"]), c["tcam"], tf_size=16, epochs=30,
        image_size=IMAGE, on_epoch=on_epoch)
    assert len(losses) == 30 and losses[-1] < losses[0]
    assert torch.equal(luts[0], torch.full((16, 4), 0.5))
    assert not torch.equal(luts[-1], tf_b.lut)
    got = dvr_render(t(c["b"]), c["tcam"], tf_b, image_size=IMAGE)
    init = dvr_render(t(c["b"]), c["tcam"],
                      TransferFunction(lut=torch.full((16, 4), 0.5),
                                       domain=tf_b.domain),
                      image_size=IMAGE)
    err_opt = float((got - target).abs().mean())
    err_init = float((init - target).abs().mean())
    assert err_opt < 0.5 * err_init


# -- the harness and the worker ----------------------------------------------

def test_optimizer_dispatch_and_size_check():
    a, b = _paired_fields(8)
    _, ttf = _tfs()
    tf_b = TFOptimizer(method="ols", tf_size=32).run(t(a), ttf, t(b))
    assert tf_b.lut.shape == (32, 4)
    assert TFOptimizer.POSSIBLE_TF_SIZES == \
        jax_tf_opt.TFOptimizer.POSSIBLE_TF_SIZES
    with pytest.raises(ValueError):
        TFOptimizer(tf_size=33).run(t(a), ttf, t(b))
    with pytest.raises(ValueError, match="camera"):
        TFOptimizer(method="diffdvr").run(t(a), ttf, t(b))
    with pytest.raises(ValueError, match="method"):
        TFOptimizer(method="bfgs").run(t(a), ttf, t(b))


def test_diffdvr_epochs_are_capped_at_100(monkeypatch):
    seen = {}
    monkeypatch.setattr(tf_opt, "optimize_tf_diffdvr",
                        lambda *a, epochs, **kw: seen.setdefault("e", epochs))
    TFOptimizer(method="diffdvr", epochs=500).run(None, None, None,
                                                   camera=object())
    assert seen["e"] == 100


def test_worker_replies_carry_request_ids():
    a, b = _paired_fields(8)
    _, ttf = _tfs()
    worker = TFOptimizationWorker()
    try:
        opt = TFOptimizer(tf_size=32)
        r0 = worker.queue_request(opt, t(a), ttf, t(b))
        r1 = worker.queue_request(TFOptimizer(method="gd", tf_size=16),
                                  t(a), ttf, t(b))
        got = {}
        for _ in range(2):
            req_id, tf_b = worker.get_reply(block=True, timeout=60)
            got[req_id] = tf_b
        assert set(got) == {r0, r1} and (r0, r1) == (0, 1)
        assert got[r0].lut.shape == (32, 4) and got[r1].lut.shape == (16, 4)
        assert _voxel_match_error(a, ttf, b, got[r0]) < 0.05
        assert worker.get_reply() is None
        worker.join(timeout=5)
    finally:
        worker.shutdown()
    assert not worker._thread.is_alive()


def test_worker_error_carries_its_id_and_shutdown_refuses():
    a, b = _paired_fields(4)
    _, ttf = _tfs()
    worker = TFOptimizationWorker()
    ok = worker.queue_request(TFOptimizer(tf_size=8), t(a), ttf, t(b))
    bad = worker.queue_request(TFOptimizer(method="diffdvr"), t(a), ttf,
                               t(b))  # no camera
    assert worker.get_reply(block=True, timeout=30)[0] == ok
    with pytest.raises(ValueError) as exc:
        worker.get_reply(block=True, timeout=30)
    assert exc.value.request_id == bad
    worker.shutdown()
    with pytest.raises(RuntimeError, match="shutdown"):
        worker.queue_request(TFOptimizer(), t(a), ttf, t(b))
