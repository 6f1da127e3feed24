"""Least-squares solvers in torch.

Counterpart of ``correrender_tpu/optim/solvers.py`` (the reference's
src/Optimization/OLS/: Eigen's dense LU/QR/Cholesky/SVD, QuadProg++ and
OSQP for non-negativity, the CUDA CGLS and LSQR of OLS/CudaSolver.cu).
JAX's ``fori_loop``s are Python loops of device tensor ops with no host
read inside, so a loop on the card queues without waiting. Products run
with TF32 off (``ops/precision.f32_matmul``); the clamps are
``torch.clamp_min(…, 1e-30)`` as JAX's ``jnp.maximum``.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.ops.precision import f32_matmul


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v))


@f32_matmul()
def cgls(a: torch.Tensor, b: torch.Tensor, iters: int = 100,
         shift: float = 0.0) -> torch.Tensor:
    """Conjugate-gradient least squares for min ‖Ax − b‖² + shift‖x‖²."""
    at_b = a.T @ b
    x = torch.zeros_like(at_b)
    r = b - a @ x
    p = a.T @ r
    gamma = torch.sum(p * p)
    for _ in range(iters):
        q = a @ p
        delta = torch.sum(q * q) + shift * torch.sum(p * p)
        alpha = gamma / torch.clamp_min(delta, 1e-30)
        x = x + alpha * p
        r = r - alpha * q
        s = a.T @ r - shift * x
        gamma_new = torch.sum(s * s)
        beta = gamma_new / torch.clamp_min(gamma, 1e-30)
        p = s + beta * p
        gamma = gamma_new
    return x


@f32_matmul()
def lsqr(a: torch.Tensor, b: torch.Tensor, iters: int = 100) -> torch.Tensor:
    """Golub–Kahan LSQR for min ‖Ax − b‖² (single right-hand side)."""
    beta = _norm(b)
    u = b / torch.clamp_min(beta, 1e-30)
    v = a.T @ u
    alpha = _norm(v)
    v = v / torch.clamp_min(alpha, 1e-30)
    w = v
    x = torch.zeros(a.shape[1], dtype=a.dtype, device=a.device)
    phi_bar = beta
    rho_bar = alpha
    for _ in range(iters):
        u = a @ v - alpha * u
        beta = _norm(u)
        u = u / torch.clamp_min(beta, 1e-30)
        v_new = a.T @ u - beta * v
        alpha = _norm(v_new)
        v_new = v_new / torch.clamp_min(alpha, 1e-30)
        rho = torch.sqrt(rho_bar**2 + beta**2)
        c = rho_bar / rho
        s = beta / rho
        theta = s * alpha
        rho_bar = -c * alpha
        phi = c * phi_bar
        phi_bar = s * phi_bar
        x = x + (phi / rho) * w
        w = v_new - (theta / rho) * w
        v = v_new
    return x


@f32_matmul()
def solve_nonneg(ata: torch.Tensor, atb: torch.Tensor,
                 iters: int = 200) -> torch.Tensor:
    """Non-negative least squares on normal equations by projected
    gradient with a Lipschitz step (QuadProg++/eigen-qp/OSQP's role): the
    step from 30 power iterations, the start from a Cholesky solve."""
    v = torch.ones(ata.shape[0], dtype=ata.dtype, device=ata.device)
    for _ in range(30):
        w = ata @ v
        v = w / torch.clamp_min(_norm(w), 1e-30)
    lip = v @ (ata @ v)  # Rayleigh quotient ≈ λ_max (ata is PSD)
    step = 1.0 / torch.clamp_min(lip, 1e-30)
    reg = ata + 1e-6 * torch.eye(ata.shape[0], dtype=ata.dtype,
                                 device=ata.device)
    chol = torch.linalg.cholesky(reg)
    x = torch.clamp_min(torch.cholesky_solve(atb[:, None], chol)[:, 0], 0.0)
    for _ in range(iters):
        grad = ata @ x - atb
        x = torch.clamp_min(x - step * grad, 0.0)
    return x


@f32_matmul()
def solve_dense(ata: torch.Tensor, atb: torch.Tensor,
                method: str = "cholesky") -> torch.Tensor:
    """Direct normal-equation solvers (Eigen's lu/cholesky/qr/svd) of
    ``(AᵀA + 1e-8·I) x = AᵀB``; ``atb`` is ``(R,)`` or ``(R, C)``.

    ``svd`` is JAX's ``jnp.linalg.lstsq``: singular values below
    ``eps · max(M, N) · σ_max`` are dropped. ``torch.linalg.lstsq`` is not
    used: on CUDA it has only the QR routine ``gels``, which differs on the
    near-singular systems that empty TF bins give.
    """
    n = ata.shape[0]
    reg = ata + 1e-8 * torch.eye(n, dtype=ata.dtype, device=ata.device)
    rhs = atb[:, None] if atb.ndim == 1 else atb
    if method in ("cholesky", "chol"):
        x = torch.cholesky_solve(rhs, torch.linalg.cholesky(reg))
    elif method == "lu":
        x = torch.linalg.solve(reg, rhs)
    elif method == "qr":
        q, r = torch.linalg.qr(reg)
        x = torch.linalg.solve_triangular(r, q.T @ rhs, upper=True)
    elif method == "svd":
        u, s, vh = torch.linalg.svd(reg, full_matrices=False)
        keep = s >= torch.finfo(reg.dtype).eps * n * s[0]
        s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
        x = vh.T @ (s_inv[:, None] * (u.T @ rhs))
    else:
        raise ValueError(f"unknown dense solver {method!r}")
    return x[:, 0] if atb.ndim == 1 else x
