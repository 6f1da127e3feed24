"""Time-series correlation heatmap (works without volume data).

Counterpart of ``correrender_tpu/diagrams/timeseries.py``. Reference:
src/Renderers/Diagram/TimeSeriesCorrelation/* — loads a (samples × time
[× window]) series set and renders the pairwise (or time-lag)
correlation heatmap; its own NetCDF loader (TimeSeriesLoader.cpp:
112-197) and optional neural estimator (MINE, models/mine.py). The
correlations run on the series' device; the loader returns a host
array and the heatmap SVG is drawn on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from correrender_tpu_torch.ops.registry import correlate


def _pick_series_variable(candidates: dict, variable, path: str) -> str:
    """Resolve the series variable with actionable errors — a raw
    KeyError/StopIteration defeated this loader's documented purpose
    (round-3 review finding)."""
    if variable is not None:
        if variable not in candidates:
            raise ValueError(
                f"variable {variable!r} in {path} is not a >=2-D "
                f"series variable; available: {sorted(candidates)}"
            )
        return variable
    if not candidates:
        raise ValueError(
            f"{path} has no >=2-D variable — the time-series diagram "
            "needs a (samples, time) series variable"
        )
    return next(iter(candidates))

def load_time_series(path: str, variable: str | None = None) -> np.ndarray:
    """Load a (samples, time) series matrix from NetCDF3/4.

    Singleton axes are squeezed (a (S, 1, T) layout is common); a
    variable that is not 2-D after squeezing is a volume, not a time
    series, and raises with an explanation instead of crashing the
    heatmap downstream (reference analogue: the TimeSeriesCorrelation
    renderer loads dedicated (samples, time) NetCDF files,
    src/Renderers/Diagram/TimeSeriesCorrelationRenderer.cpp)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:3] == b"CDF":
        import scipy.io

        nc = scipy.io.netcdf_file(path, "r", mmap=False)
        try:
            candidates = {
                k: v for k, v in nc.variables.items()
                if v.data.ndim >= 2
            }
            name = _pick_series_variable(candidates, variable, path)
            arr = np.asarray(candidates[name].data, np.float32)
        finally:
            nc.close()
    else:
        import h5py

        with h5py.File(path, "r") as f:
            candidates = {
                k: v for k, v in f.items()
                if getattr(v, "ndim", 0) >= 2
            }
            name = _pick_series_variable(candidates, variable, path)
            arr = np.asarray(f[name][...], np.float32)
    # Squeeze only when MORE than 2 axes remain: a legitimate (1, T)
    # single-sample series keeps its sample axis (a plain np.squeeze
    # turned it 1-D and rejected a valid file — round-3 self-review).
    if arr.ndim > 2:
        arr = np.squeeze(arr)
    if arr.ndim == 1:
        arr = arr[None, :]  # fully-singleton leading axes: one series
    if arr.ndim != 2:
        raise ValueError(
            f"variable {name!r} in {path} has shape {arr.shape} after "
            "squeezing — the time-series diagram needs a (samples, "
            "time) 2-D series variable, not a volume; use "
            "'diagram --kind matrix' for volume ensembles"
        )
    return arr


def time_series_correlation_neural(
    series,
    steps: int = 300,
    hidden: int = 32,
    seed: int = 0,
) -> torch.Tensor:
    """Pairwise MI heatmap from per-pair MINE statistic networks.

    The reference's neural estimator mode
    (TimeSeriesCorrelationRenderer.cu, SSDBM 2024): one tiny network
    per heatmap cell estimates the Donsker–Varadhan MI bound between
    the two series; all P = S(S+1)/2 nets train at once
    (models/mine.py::train_mine_batched), on the series' device.
    """
    from correrender_tpu_torch.models.mine import (
        MineEstimator,
        train_mine_batched,
    )

    s = torch.as_tensor(series).to(torch.float32)
    # Normalize each series (MINE statistic nets are scale-sensitive).
    s = (s - s.mean(dim=1, keepdim=True)) / (
        s.std(dim=1, unbiased=False, keepdim=True) + 1e-8
    )
    n = s.shape[0]
    iu, ju = (torch.as_tensor(v, device=s.device)
              for v in np.triu_indices(n, k=0))
    est = MineEstimator.create(hidden=hidden, num_layers=3)
    mi = train_mine_batched(est, s[iu], s[ju], steps=steps, seed=seed)
    out = torch.zeros((n, n), dtype=torch.float32, device=s.device)
    out[iu, ju] = mi
    out[ju, iu] = mi
    return out


def time_series_correlation(
    series,
    measure: str = "pearson",
    window: int | None = None,
    estimator: str = "classical",
    **measure_kw,
) -> torch.Tensor:
    """Pairwise correlation of (S, T) series → (S, S) heatmap, on the
    series' device (an array becomes a CPU tensor).

    ``estimator="mine"`` switches to the neural MI estimator
    (:func:`time_series_correlation_neural`; pairwise mode only).

    With ``window``, computes the time-lag correlation map instead:
    out[i, lag] = corr(series[i, :window], series[i, lag:lag + window]).
    """
    if estimator == "mine":
        if window is not None:
            raise ValueError(
                "the neural estimator supports the pairwise mode only"
            )
        return time_series_correlation_neural(series, **measure_kw)
    s = torch.as_tensor(series).to(torch.float32)
    if window is None:
        return correlate(s[:, None, :], s[None, :, :], measure, **measure_kw)
    num_lags = s.shape[1] - window + 1
    base = s[:, :window]
    lags = s.unfold(1, window, 1)[:, :num_lags]  # (S, L, window)
    return correlate(base[:, None, :], lags, measure, **measure_kw)


def render_heatmap_svg(matrix, path=None, size: int = 600,
                       colormap: str = "coolwarm", domain=(-1.0, 1.0)) -> str:
    """Heat-map SVG of an (S, S) or (S, L) matrix (array or tensor)."""
    from correrender_tpu_torch.diagrams.svg import SvgCanvas
    # render.tf imports this package (its colormaps).
    from correrender_tpu_torch.render.tf import TransferFunction

    if isinstance(matrix, torch.Tensor):
        matrix = matrix.cpu().numpy()
    tf = TransferFunction.from_colormap(colormap, domain=(0, 1))
    lut = tf.lut.cpu().numpy()
    rows, cols = matrix.shape
    cell_w = size / cols
    cell_h = size / rows
    canvas = SvgCanvas(size, size)
    lo, hi = domain
    for i in range(rows):
        for j in range(cols):
            v = matrix[i, j]
            if not np.isfinite(v):
                color = (0.5, 0.5, 0.5)
            else:
                t = float(np.clip((v - lo) / (hi - lo), 0, 1))
                color = tuple(lut[int(t * 255)][:3])
            canvas.rect(j * cell_w, i * cell_h, cell_w + 0.5, cell_h + 0.5,
                        fill=color)
    if path:
        canvas.save(path)
    return canvas.to_svg()
