"""Sampling-method evaluation harness (the --sampling mode).

Counterpart of ``correrender_tpu/app/sampling_test.py``, on the port's
``ops``, ``diagrams/octree.py``, ``diagrams/sampling.py`` and
``diagrams/bayopt.py``; the stack lies on ``device`` (the card unless the
caller passes ``device="cpu"``). Reference:
src/Renderers/Diagram/SamplingTest.cpp — sweeps sampling
configurations {method, numSamples, BO iterations} over block pairs,
compares each method's estimated max-correlation against the exhaustive
ground truth, and reports per-config:

* errorQuantile — 1 − rank of the found maximum among all ground-truth
  pair values (binary-search rank, SamplingTest.cpp:63-115);
* errorLinear — (trueMax − found) / (trueMax − trueMin);
* errorAbsolute — trueMax − found;
* elapsed µs per pair, averaged over numRuns;

written as a CSV (SamplingTest.cpp:351-364). Test cases cover real
data blocks and the synthetic correlated-Gaussian pairs
(Diagram/Test/MultivariateGaussian.*).
"""

from __future__ import annotations

import csv
import dataclasses
import time

import numpy as np
import torch

from correrender_tpu_torch import ops
from correrender_tpu_torch.diagrams.octree import GridRegion
from correrender_tpu_torch.diagrams import sampling
from correrender_tpu_torch.utils import fixtures


@dataclasses.dataclass
class SamplingTestCase:
    """One sweep configuration (SamplingTest.cpp:43-60 analogue)."""

    method: str
    num_samples: int = 100
    num_init: int = 20  # Bayesian-opt initial probes
    num_runs: int = 4
    subsample: int = 1  # mean-field subsampling factor f


DEFAULT_CASES = [
    SamplingTestCase("mean", 1),
    SamplingTestCase("random", 50),
    SamplingTestCase("random", 100),
    SamplingTestCase("halton", 100),
    SamplingTestCase("plastic", 100),
    SamplingTestCase("bayesian", 60, num_init=20, num_runs=2),
]


def _ground_truth(stack, ra, rb, measure, **kw):
    def region_series(r):
        sub = stack[
            r.z_min : r.z_max + 1, r.y_min : r.y_max + 1,
            r.x_min : r.x_max + 1,
        ]
        return sub.reshape(-1, sub.shape[-1])

    sa = region_series(ra)
    sb = region_series(rb)
    vals = ops.correlate(sa[:, None, :], sb[None, :, :], measure,
                         absolute=True, **kw).cpu().numpy().ravel()
    return np.sort(vals[np.isfinite(vals)])


def _device_stack(stack, device) -> torch.Tensor:
    """A ``(Z, Y, X, n)`` stack as a float32 tensor on ``device``."""
    return torch.as_tensor(stack, dtype=torch.float32, device=device)


def _synthetic_stack(xs, ys, zs, seed, device) -> torch.Tensor:
    data = fixtures.synth_box_ensemble(xs=xs, ys=ys, zs=zs, members=100,
                                       seed=seed)
    return _device_stack(np.ascontiguousarray(np.moveaxis(data, 0, -1)),
                         device)


def evaluate_case(stack, ra, rb, case, measure="pearson",
                  truth=None, **kw):
    """Run one test case on one block pair; returns metric dict.
    ``stack`` is a ``(Z, Y, X, n)`` tensor (the samplers run on its
    device).

    ``truth``: precomputed sorted ground-truth values for this
    (pair, measure): the harness computes it once per pair and
    passes it in, not once per case.
    """
    if truth is None:
        truth = _ground_truth(stack, ra, rb, measure, **kw)
    if len(truth) == 0:
        raise ValueError(
            "sampling test: every ground-truth correlation for this "
            "block pair is non-finite (constant/masked region) — "
            "choose different blocks or a different field"
        )
    t_max, t_min = truth[-1], truth[0]
    found, micros = [], []
    for run in range(case.num_runs):
        t0 = time.perf_counter()
        extra = {}
        if case.method == "bayesian":
            extra["num_init"] = case.num_init
        if case.method == "mean":
            extra["subsample"] = case.subsample
        est = sampling.sample_block_pair_max(
            stack, ra, rb, measure,
            method=case.method,
            num_samples=case.num_samples,
            seed=run,
            **extra,
            **kw,
        )
        micros.append((time.perf_counter() - t0) * 1e6)
        found.append(est)
    found = np.asarray(found)
    ranks = np.searchsorted(truth, found, side="right")
    error_quantile = 1.0 - ranks / len(truth)
    denom = max(t_max - t_min, 1e-30)
    return {
        "method": case.method,
        "num_samples": case.num_samples,
        "subsample": case.subsample,
        "error_quantile": float(error_quantile.mean()),
        "error_linear": float(((t_max - found) / denom).mean()),
        "error_absolute": float((t_max - found).mean()),
        "time_us": float(np.mean(micros)),
    }


def run_sampling_tests(
    stack=None,
    cases=None,
    measure: str = "pearson",
    num_pairs: int = 4,
    block: int = 8,
    csv_path: str | None = None,
    synthetic: bool = False,
    seed: int = 0,
    device="cuda",
):
    """Full harness: sample block pairs, sweep cases, optional CSV.

    With ``synthetic=True`` uses correlated-Gaussian block pairs with
    known structure (TEST_CASE_SYNTH_* analogue); otherwise slices
    block pairs out of ``stack`` (TEST_CASE_DATA_*). The stack is moved
    to ``device``.
    """
    cases = cases or DEFAULT_CASES
    rng = np.random.default_rng(seed)
    if synthetic or stack is None:
        stack = _synthetic_stack(4 * block, 4 * block, block, seed, device)
    else:
        stack = _device_stack(stack, device)
    zs, ys, xs, _ = stack.shape

    pairs = []
    for _ in range(num_pairs):
        def rand_region():
            # +1: integers() excludes the high bound, which would
            # exclude block origins touching the domain's max edge.
            x0 = int(rng.integers(0, max(xs - block + 1, 1)))
            y0 = int(rng.integers(0, max(ys - block + 1, 1)))
            z0 = int(rng.integers(0, max(zs - block + 1, 1)))
            return GridRegion(
                x0, y0, z0,
                min(x0 + block - 1, xs - 1),
                min(y0 + block - 1, ys - 1),
                min(z0 + block - 1, zs - 1),
            )

        pairs.append((rand_region(), rand_region()))

    truths = [
        _ground_truth(stack, ra, rb, measure) for ra, rb in pairs
    ]
    rows = []
    for case in cases:
        metrics = [
            evaluate_case(stack, ra, rb, case, measure, truth=truth)
            for (ra, rb), truth in zip(pairs, truths)
        ]
        row = {
            "method": case.method,
            "num_samples": case.num_samples,
            "subsample": case.subsample,
        }
        for key in ("error_quantile", "error_linear", "error_absolute",
                    "time_us"):
            row[key] = round(
                float(np.mean([m[key] for m in metrics])), 6
            )
        rows.append(row)

    if csv_path:
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    return rows


def run_screened_sampling_tests(
    stack=None,
    measure: str = "pearson",
    num_pairs: int = 32,
    block: int = 8,
    num_samples: int = 60,
    num_init: int = 20,
    top_frac: float = 0.25,
    csv_path: str | None = None,
    synthetic: bool = True,
    seed: int = 0,
    device="cuda",
):
    """Screened-bayesian evaluation ON the sampling harness.

    Screening is a *population* strategy (serve every pair a cheap
    quasirandom pass, spend the GP budget on the top fraction —
    diagrams/heb.py), so this harness evaluates a population of block
    pairs through the PRODUCTION batched paths and reports the same
    errorQuantile/Linear/Absolute metrics as the per-pair harness
    (SamplingTest.cpp:63-115 semantics) for:

    * ``bayesian_full``     — batched GP on every pair;
    * ``bayesian_screened`` — HEB's screening pipeline (plastic
      pre-pass on all pairs, GP refinement on the top ``top_frac``);
    * ``plastic_budget``    — plain plastic sampling given the
      screened pipeline's measured wall budget (sample count scaled
      up until its wall time matches: screening stays the default
      only while its errorQuantile ≤ this row's).

    Returns rows (one per strategy) with per-pair-averaged metrics
    and wall time per pair.
    """
    from correrender_tpu_torch.diagrams.bayopt import (
        batched_bayesian_opt_max)
    from correrender_tpu_torch.diagrams.sampling import (
        batched_block_pairs_max)

    rng = np.random.default_rng(seed)
    if synthetic or stack is None:
        stack = _synthetic_stack(6 * block, 6 * block, 2 * block, seed,
                                 device)
    else:
        stack = _device_stack(stack, device)
    zs, ys, xs, _ = stack.shape

    def rand_region():
        x0 = int(rng.integers(0, max(xs - block + 1, 1)))
        y0 = int(rng.integers(0, max(ys - block + 1, 1)))
        z0 = int(rng.integers(0, max(zs - block + 1, 1)))
        return GridRegion(
            x0, y0, z0,
            min(x0 + block - 1, xs - 1),
            min(y0 + block - 1, ys - 1),
            min(z0 + block - 1, zs - 1),
        )

    pairs = [(rand_region(), rand_region()) for _ in range(num_pairs)]
    ras = [p[0] for p in pairs]
    rbs = [p[1] for p in pairs]
    truths = [_ground_truth(stack, ra, rb, measure)
              for ra, rb in pairs]

    def metrics(found, name, wall_s, extra=None):
        found = np.asarray(found, np.float64)
        eq, el, ea = [], [], []
        for f, truth in zip(found, truths):
            t_max, t_min = truth[-1], truth[0]
            rank = np.searchsorted(truth, f, side="right")
            eq.append(1.0 - rank / len(truth))
            el.append((t_max - f) / max(t_max - t_min, 1e-30))
            ea.append(t_max - f)
        row = {
            "method": name,
            "num_samples": num_samples,
            "subsample": 1,
            "error_quantile": round(float(np.mean(eq)), 6),
            "error_linear": round(float(np.mean(el)), 6),
            "error_absolute": round(float(np.mean(ea)), 6),
            "time_us": round(wall_s / num_pairs * 1e6, 1),
        }
        if extra:
            row.update(extra)
        return row

    sj = stack

    def run_full():
        return np.asarray(batched_bayesian_opt_max(
            sj, ras, rbs, measure, num_init=num_init,
            num_iters=max(num_samples - num_init, 0)))

    def run_screened():
        top_k = max(2, int(np.ceil(top_frac * num_pairs)))
        screen = np.asarray(batched_block_pairs_max(
            sj, ras, rbs, measure, method="plastic",
            num_samples=max(4, num_init // 2)), np.float32)
        top = np.argsort(-np.abs(np.nan_to_num(screen)))[:top_k]
        refined = batched_bayesian_opt_max(
            sj, [ras[t] for t in top], [rbs[t] for t in top],
            measure, num_init=num_init,
            num_iters=max(num_samples - num_init, 0))
        flat = screen.astype(np.float64)
        flat[top] = np.asarray(refined, np.float64)
        return flat

    def run_plastic(n):
        return np.asarray(batched_block_pairs_max(
            sj, ras, rbs, measure, method="plastic", num_samples=n))

    def timed(fn, *args):
        fn(*args)  # warm/compile
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    full_vals, full_s = timed(run_full)
    scr_vals, scr_s = timed(run_screened)
    # Plastic at the screened pipeline's wall budget: scale the sample
    # count by measured throughput (calibrate on the harness's default
    # count, then one sizing step).
    _, base_s = timed(run_plastic, num_samples)
    n_budget = max(num_samples,
                   int(num_samples * scr_s / max(base_s, 1e-9)))
    pl_vals, pl_s = timed(run_plastic, n_budget)

    rows = [
        metrics(full_vals, "bayesian_full", full_s),
        metrics(scr_vals, "bayesian_screened", scr_s,
                {"top_frac": top_frac}),
        metrics(pl_vals, "plastic_budget", pl_s,
                {"budget_samples": n_budget}),
    ]
    if csv_path:
        keys = sorted({k for r in rows for k in r})
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            writer.writerows(rows)
    return rows


#: Reference test indices (SamplingTest.cpp:150-153).
TEST_CASE_SYNTH_ERROR = 0
TEST_CASE_DATA_ERROR = 1
TEST_CASE_DATA_MAX = 2
TEST_CASE_DATA_MAX_SUBSAMPLED = 3

_EQUAL_BUDGET_CASES = [
    # Equal-budget comparison: does BayOpt's model-guided probing beat
    # the quasirandom samplers at the same evaluation count?
    SamplingTestCase("random", 60),
    SamplingTestCase("halton", 60),
    SamplingTestCase("plastic", 60),
    SamplingTestCase("bayesian", 60, num_init=20, num_runs=2),
]

_SUBSAMPLED_CASES = [
    SamplingTestCase("mean", 1, subsample=f) for f in (1, 2, 4, 8)
]


def _load_stack(dataset: str, field: str | None = None, device="cuda"):
    from correrender_tpu_torch.io import load_volume

    vd = load_volume(dataset, device=device)
    name = field or vd.field_names[0]
    return vd.get_member_stack(name)


def run_sampling_test_index(
    test_index: int,
    dataset: str | None = None,
    field: str | None = None,
    csv_path: str | None = None,
    num_pairs: int = 4,
    block: int = 8,
    seed: int = 0,
    device="cuda",
):
    """Run one of the reference's four indexed sampling tests
    (runSamplingTests(dataSetPath, testIdx), SamplingTest.cpp:150-155).

    SYNTH_ERROR uses the correlated synthetic ensemble; the DATA_*
    cases run against a real dataset file (any registered loader).
    """
    stack = None
    synthetic = test_index == TEST_CASE_SYNTH_ERROR
    if not synthetic:
        if dataset is None:
            raise ValueError(
                f"test index {test_index} is data-driven; pass a dataset"
            )
        stack = _load_stack(dataset, field, device)
    if test_index in (TEST_CASE_SYNTH_ERROR, TEST_CASE_DATA_ERROR):
        cases = DEFAULT_CASES
    elif test_index == TEST_CASE_DATA_MAX:
        cases = _EQUAL_BUDGET_CASES
    elif test_index == TEST_CASE_DATA_MAX_SUBSAMPLED:
        cases = _SUBSAMPLED_CASES
    else:
        raise ValueError(f"unknown sampling test index {test_index}")
    return run_sampling_tests(
        stack=stack, cases=cases, num_pairs=num_pairs, block=block,
        csv_path=csv_path, synthetic=synthetic, seed=seed, device=device,
    )
