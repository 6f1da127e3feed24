"""Inverse optimization (the reference's src/Optimization/).

Counterpart of ``correrender_tpu/optim``: fit a transfer function for
field B so that rendering B reproduces field A under its TF, by OLS
(dense and iterative solvers, non-negativity), GD (Adam or SGD) or
DiffDVR (autograd through the renderer).
"""

from correrender_tpu_torch.optim.tf_opt import (
    TFOptimizationWorker,
    TFOptimizer,
    optimize_tf_ols,
    optimize_tf_gd,
    optimize_tf_diffdvr,
)
from correrender_tpu_torch.optim.solvers import cgls, lsqr, solve_nonneg

__all__ = [
    "TFOptimizationWorker",
    "TFOptimizer",
    "optimize_tf_ols",
    "optimize_tf_gd",
    "optimize_tf_diffdvr",
    "cgls",
    "lsqr",
    "solve_nonneg",
]
