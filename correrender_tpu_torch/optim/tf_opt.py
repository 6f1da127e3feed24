"""Transfer-function optimization.

Counterpart of ``correrender_tpu/optim/tf_opt.py``: fit an RGBA LUT for
field B such that rendering B reproduces field A rendered with a known
TF. Reference: src/Optimization/TFOptimization.* (a worker thread with a
request and reply queue) with the methods OLS, GD and DiffDVR
(OptDefines.hpp:32-40) and the TF sizes ``possibleTfSizes`` {2..256}
(TFOptimization.hpp:47-49).

The linear model (OLS, GD): every voxel constrains
``two_hot(B[v]) · X ≈ TF_A(A[v])``; the normal equations are built from
``render/classify.py``'s weights in voxel slabs (the reference's
NormalEquations.glsl). DiffDVR differentiates the renderer itself: torch
autograd through the plain marcher ``render/dvr.py::dvr_render``, as JAX
takes ``jax.grad`` through its ``dvr_render`` (the reference needed a
hand-written adjoint pass, DvrAdjoint.glsl). No Pallas kernel lies on any
of these paths in JAX, so none does here.

Everything runs on the fields' device; the loops are Python loops of
device tensor ops. JAX keeps a cache of compiled DiffDVR epoch loops
(``_DIFFDVR_PROGRAMS``); the port compiles nothing, so it has none.
"""

from __future__ import annotations

import dataclasses

import torch

from correrender_tpu_torch.ops.precision import f32_matmul
from correrender_tpu_torch.optim import solvers
from correrender_tpu_torch.render.classify import classify, two_hot_weights
from correrender_tpu_torch.render.tf import TransferFunction
from correrender_tpu_torch.utils.histogram import nanmax, nanmin

#: Voxels × tf_size budget for the dense (V, R) weight intermediate: past
#: it the normal equations are accumulated in voxel slabs (1 Mi voxels a
#: slab at R = 64, 256 MB of weights).
_DENSE_WEIGHT_ELEMS = 64 * 1024 * 1024


def _nan_range(values: torch.Tensor) -> tuple:
    """``(nanmin, nanmax)`` as host floats (one read of the device)."""
    lo, hi = torch.stack([nanmin(values), nanmax(values)]).tolist()
    return (lo, hi)


@f32_matmul()
def _normal_eq_slab(a_vals, b_vals, tf_a, domain_b, tf_size):
    """One slab's contribution to the normal equations: ``(AᵀA, AᵀB,
    Σtarget²)`` for rows ``two_hot(B[v])`` and targets ``TF_A(A[v])``."""
    target = classify(a_vals, tf_a.lut, tf_a.domain, premultiply=False)
    w = two_hot_weights(b_vals, domain_b, tf_size)
    return w.T @ w, w.T @ target, torch.sum(target * target, dim=0)


def _normal_equations(a_vals, b_vals, tf_a, domain_b, tf_size):
    """Accumulate ``(AᵀA, AᵀB, Σtarget²)`` over voxel slabs, so the dense
    (V, R) weights never exceed the budget."""
    slab = max(_DENSE_WEIGHT_ELEMS // max(tf_size, 1), 1)
    dev = a_vals.device
    ata = torch.zeros((tf_size, tf_size), dtype=torch.float32, device=dev)
    atb = torch.zeros((tf_size, 4), dtype=torch.float32, device=dev)
    btb = torch.zeros((4,), dtype=torch.float32, device=dev)
    for v0 in range(0, a_vals.shape[0], slab):
        pa, pb, pc = _normal_eq_slab(a_vals[v0:v0 + slab],
                                     b_vals[v0:v0 + slab], tf_a, domain_b,
                                     tf_size)
        ata, atb, btb = ata + pa, atb + pb, btb + pc
    return ata, atb, btb


def optimize_tf_ols(field_a: torch.Tensor, tf_a: TransferFunction,
                    field_b: torch.Tensor, tf_size: int = 64, domain_b=None,
                    solver: str = "cholesky", nonneg: bool = True,
                    iters: int = 200) -> TransferFunction:
    """Least-squares TF fit (reference TFOptimizerOLS).

    Args:
      field_a: ``(Z, Y, X)`` source field with known TF ``tf_a`` (its LUT
        on the field's device).
      field_b: ``(Z, Y, X)`` field to fit a TF for, on the same device.
      tf_size: LUT resolution of the fitted TF.
      solver: "cholesky" | "lu" | "qr" | "svd" | "cgls" | "lsqr".
      nonneg: a non-negative LUT by projected NNLS (dense solvers). With
        "cgls"/"lsqr" on a small problem the unconstrained iterative
        solution is only clipped to [0, 1].
    """
    a_vals = field_a.reshape(-1)
    b_vals = field_b.reshape(-1)
    if domain_b is None:
        domain_b = _nan_range(b_vals)
    small = a_vals.shape[0] * tf_size <= _DENSE_WEIGHT_ELEMS
    if solver in ("cgls", "lsqr") and small:
        # The iterative solvers work on (w, target) directly; the (R, R)
        # normal equations are formed only for the dense branches.
        target = classify(a_vals, tf_a.lut, tf_a.domain, premultiply=False)
        w = two_hot_weights(b_vals, domain_b, tf_size)
        fn = solvers.cgls if solver == "cgls" else solvers.lsqr
        x = torch.stack([fn(w, target[:, c], iters=iters) for c in range(4)],
                        dim=-1)
    else:
        ata, atb, _ = _normal_equations(a_vals, b_vals, tf_a, domain_b,
                                        tf_size)
        if solver in ("cgls", "lsqr"):
            # Past the budget the iterative solvers run on the (R, R)
            # normal equations (the same least-squares solution).
            x = torch.stack([solvers.cgls(ata, atb[:, c], iters=iters)
                             for c in range(4)], dim=-1)
        elif nonneg:
            x = torch.stack([solvers.solve_nonneg(ata, atb[:, c], iters=iters)
                             for c in range(4)], dim=-1)
        else:
            x = solvers.solve_dense(ata, atb, solver)
    return TransferFunction(lut=torch.clamp(x, 0.0, 1.0),
                            domain=tuple(domain_b))


def optimize_tf_gd(field_a, tf_a: TransferFunction, field_b,
                   tf_size: int = 64, domain_b=None, epochs: int = 200,
                   learning_rate: float = 0.05,
                   optimizer: str = "adam") -> TransferFunction:
    """Adam or SGD on the voxel-matching loss (reference GD/OptimizerPass).

    The MSE over voxels is a quadratic in the LUT,
    ``(lutᵀAᵀA lut − 2 lutᵀAᵀB + BᵀB)/V``, so the loop runs on the
    accumulated (R, R) normal equations: the gradient equals
    differentiating through the dense (V, R) weights.
    """
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}; one of adam/sgd")
    a_vals = field_a.reshape(-1)
    b_vals = field_b.reshape(-1)
    if domain_b is None:
        domain_b = _nan_range(b_vals)
    ata, atb, _ = _normal_equations(a_vals, b_vals, tf_a, domain_b, tf_size)
    lut0 = torch.full((tf_size, 4), 0.5, dtype=torch.float32,
                      device=a_vals.device)
    lut = _gd_run(lut0, ata, atb, float(a_vals.shape[0]), learning_rate,
                  n=int(epochs), use_adam=optimizer == "adam")
    return TransferFunction(lut=lut, domain=tuple(domain_b))


def adam_step(lut, g, m, v, t: int, lr: float):
    """One Adam step (β 0.9, 0.999, ε 1e-8) and the clip to [0, 1], as
    ``tf_opt.py`` writes it in JAX (``torch.optim.Adam`` does not clip).
    Returns ``(lut, m, v)``; ``t`` counts from 1."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    mhat = m / (1 - 0.9**t)
    vhat = v / (1 - 0.999**t)
    lut = lut - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return torch.clamp(lut, 0.0, 1.0), m, v


@f32_matmul()
def _gd_run(lut0, ata, atb, v_count: float, lr: float, n: int,
            use_adam: bool):
    lut = lut0
    m = v = torch.zeros_like(lut0)
    for i in range(n):
        # d/dlut mean((w·lut − target)²) = 2 (AᵀA lut − AᵀB) / V
        g = 2.0 * (ata @ lut - atb) / v_count
        if use_adam:
            lut, m, v = adam_step(lut, g, m, v, i + 1, lr)
        else:
            lut = torch.clamp(lut - lr * g, 0.0, 1.0)
    return lut


def diffdvr_loss(lut, field_b, target, camera, domain_b, image_size,
                 loss: str = "l2", attenuation: float = 100.0,
                 smoothing_weight: float = 1e-3):
    """DiffDVR's loss of a LUT: the image term (``l1`` or ``l2``) of
    ``dvr_render(field_b)`` against ``target``, plus ``smoothing_weight``
    times the mean squared first difference of the LUT (the reference's
    Loss.glsl and SmoothingPrior.glsl)."""
    from correrender_tpu_torch.render.dvr import dvr_render

    img = dvr_render(field_b, camera,
                     TransferFunction(lut=lut, domain=tuple(domain_b)),
                     image_size=image_size, attenuation=attenuation)
    diff = img - target
    data = diff.abs().mean() if loss == "l1" else (diff * diff).mean()
    step = lut[1:] - lut[:-1]
    return data + smoothing_weight * (step * step).mean()


def diffdvr_grad(lut, *args, **kw):
    """``(loss, ∂loss/∂lut)`` of :func:`diffdvr_loss` by autograd through
    ``dvr_render``. On the card the LUT gather's backward accumulates with
    atomics, so the gradient is not bit-stable from run to run."""
    lut = lut.detach().requires_grad_()
    value = diffdvr_loss(lut, *args, **kw)
    (g,) = torch.autograd.grad(value, lut)
    return value.detach(), g


def optimize_tf_diffdvr(field_a, tf_a: TransferFunction, field_b, camera,
                        tf_size: int = 32, domain_b=None, epochs: int = 60,
                        learning_rate: float = 0.1, image_size=(64, 64),
                        smoothing_weight: float = 1e-3, loss: str = "l2",
                        attenuation: float = 100.0,
                        on_epoch=None) -> TransferFunction:
    """Differentiable-DVR TF fit: Adam on gradients through the marcher.

    The reference runs forward and adjoint GLSL passes with an image loss
    and a smoothing prior (src/Optimization/DiffDVR/); here the adjoint
    is autograd through the display renderer ``render/dvr.py``.
    ``on_epoch(i, loss, lut, grad)``, if given, is called after each
    epoch's gradient with the epoch's loss (a 0-dim device tensor), the
    LUT the gradient was taken at and the gradient.
    """
    from correrender_tpu_torch.render.dvr import dvr_render

    if loss not in ("l1", "l2"):
        raise ValueError(f"unknown loss {loss!r}; one of l1/l2")
    if domain_b is None:
        domain_b = _nan_range(field_b.reshape(-1))
    with torch.no_grad():
        target = dvr_render(field_a, camera, tf_a, image_size=image_size,
                            attenuation=attenuation)
    lut = torch.full((tf_size, 4), 0.5, dtype=torch.float32,
                     device=field_b.device)
    m = v = torch.zeros_like(lut)
    for i in range(int(epochs)):
        value, g = diffdvr_grad(lut, field_b, target, camera, domain_b,
                                tuple(image_size), loss, attenuation,
                                smoothing_weight)
        if on_epoch is not None:
            on_epoch(i, value, lut, g)
        lut, m, v = adam_step(lut, g, m, v, i + 1, learning_rate)
    return TransferFunction(lut=lut, domain=tuple(domain_b))


@dataclasses.dataclass
class TFOptimizer:
    """Request and execute wrapper with the reference's
    TFOptimizationWorker settings (method, TF size, epochs)."""

    method: str = "ols"  # "ols" | "gd" | "diffdvr"
    tf_size: int = 64
    epochs: int = 200
    solver: str = "cholesky"

    POSSIBLE_TF_SIZES = (2, 4, 8, 16, 32, 64, 128, 256)

    def run(self, field_a, tf_a, field_b, camera=None, **kw):
        if self.tf_size not in self.POSSIBLE_TF_SIZES:
            raise ValueError(
                f"tf_size must be one of {self.POSSIBLE_TF_SIZES}")
        if self.method == "ols":
            return optimize_tf_ols(field_a, tf_a, field_b, self.tf_size,
                                   solver=self.solver, **kw)
        if self.method == "gd":
            return optimize_tf_gd(field_a, tf_a, field_b, self.tf_size,
                                  epochs=self.epochs, **kw)
        if self.method == "diffdvr":
            if camera is None:
                raise ValueError("diffdvr needs a camera")
            return optimize_tf_diffdvr(field_a, tf_a, field_b, camera,
                                       self.tf_size,
                                       epochs=min(self.epochs, 100), **kw)
        raise ValueError(f"unknown method {self.method!r}")


class TFOptimizationWorker:
    """Background TF-optimization worker with a request and reply queue.

    The reference's worker thread (TFOptimization.hpp:51-90:
    ``queueRequest`` from the GUI thread, a non-blocking ``getReply``
    polled each frame), so an interactive front end never blocks on a
    fit. One daemon thread drains the requests in order; replies carry
    the request id.
    """

    def __init__(self):
        import queue
        import threading

        self._requests: "queue.Queue" = queue.Queue()
        self._replies: "queue.Queue" = queue.Queue()
        self._next_id = 0
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._requests.get()
            if item is None:
                self._requests.task_done()
                return
            req_id, optimizer, args, kw = item
            try:
                result = optimizer.run(*args, **kw)
                self._replies.put((req_id, result, None))
            except Exception as exc:  # surfaced by get_reply
                self._replies.put((req_id, None, exc))
            finally:
                self._requests.task_done()

    def queue_request(self, optimizer: TFOptimizer, *args, **kw) -> int:
        """Enqueue a fit; returns the request id its reply will carry.

        Raises RuntimeError after :meth:`shutdown`: the loop has exited,
        so the request would never run and a blocking wait on it would
        hang.
        """
        if self._closed:
            raise RuntimeError(
                "TFOptimizationWorker.queue_request after shutdown()")
        req_id = self._next_id
        self._next_id += 1
        self._requests.put((req_id, optimizer, args, kw))
        return req_id

    def get_reply(self, block: bool = False, timeout=None):
        """The next finished fit as ``(request_id, result)``, or None when
        none is ready. A failed fit raises its exception here, on the
        caller's thread, with the request's id as ``exc.request_id``."""
        import queue

        try:
            req_id, result, exc = self._replies.get(block=block,
                                                    timeout=timeout)
        except queue.Empty:
            return None
        if exc is not None:
            exc.request_id = req_id
            raise exc
        return req_id, result

    def join(self, timeout=None):
        """Block until every queued request is processed, the one in
        flight included (the queue's unfinished-task count)."""
        import time

        if timeout is None:
            self._requests.join()
            return
        deadline = time.time() + timeout
        while self._requests.unfinished_tasks:
            if time.time() > deadline:
                return
            time.sleep(0.01)

    def shutdown(self):
        self._closed = True
        self._requests.put(None)
        self._thread.join(timeout=5)
