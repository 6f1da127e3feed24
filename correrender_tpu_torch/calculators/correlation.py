"""Correlation fields and the correlation calculator.

Counterpart of ``correrender_tpu/calculators/correlation.py``
(``correlate_field``, ``CorrelationCalculator``). Each measure against
one reference series takes its kernel route, as the JAX package's TPU
branches do (:234-296), the wrapper choosing by the tensor's device (a
CPU tensor runs the plain version): Pearson → K1, Spearman → B7,
Kendall → B8, the Kraskov measures → B10. The binned-MI measures, and
every measure against a per-voxel reference series (the
SEPARATE_SYMMETRIC field mode), take the voxel-chunked torch path of
``ops.correlate`` under a memory budget, as in the JAX package.

The JAX version flattens large stacks in 1 GiB Z-slabs because a TPU
reshape retiles and copies; in PyTorch ``stack.reshape(-1, n)`` of a
contiguous stack is a view, so the stack goes to the kernels whole. A
time-lag window ``stack[..., :T - lag]`` flattens to a view with rows
``T`` apart, which the kernels do not take: it is copied once into a
fresh, aligned buffer, so K1 keeps its tiled regime.
"""

from __future__ import annotations

import torch

from correrender_tpu_torch.calculators.base import (
    Calculator,
    register_calculator_type,
)
from correrender_tpu_torch.ops.cuda.kendall_kernel import kendall_cuda
from correrender_tpu_torch.ops.cuda.ksg_banded import mi_ksg_banded
from correrender_tpu_torch.ops.cuda.moments_kernel import chunk_moments_flat
from correrender_tpu_torch.ops.cuda.pearson_kernel import pearson_cuda
from correrender_tpu_torch.ops.cuda.spearman_kernel import spearman_cuda
from correrender_tpu_torch.ops.mi_ksg import kmi_correlation_coefficient
from correrender_tpu_torch.ops.pearson import pearson_from_moments
from correrender_tpu_torch.ops.registry import (
    MEASURE_NAMES,
    CorrelationMeasure,
    correlate,
    is_measure_binned_mi,
    is_measure_kraskov_mi,
    measure_from_id,
)
from correrender_tpu_torch.utils.profiling import zone

#: Voxel-chunk memory budget of the chunked torch path.
DEFAULT_CHUNK_BUDGET_BYTES = 256 << 20


def _auto_chunk(n: int, budget: int, num_bins: int = 80,
                measure=CorrelationMeasure.MUTUAL_INFORMATION_BINNED) -> int:
    """A voxel chunk whose working set fits the budget: the JAX
    package's per-measure sizes, without its lane alignment."""
    if measure in (CorrelationMeasure.PEARSON, CorrelationMeasure.SPEARMAN):
        per_voxel = 16 * n
    elif measure == CorrelationMeasure.KENDALL:
        per_voxel = 4 * n * min(n, 128) * 3
    elif is_measure_binned_mi(measure):
        per_voxel = 4 * n * num_bins * 2 + 4 * num_bins * num_bins
    else:  # Kraskov
        per_voxel = 4 * n * n * 3
    return int(max(budget // per_voxel, 1))


def _correlate_chunked(series: torch.Tensor, ref: torch.Tensor,
                       measure: CorrelationMeasure, voxel_chunk: int,
                       **kwargs) -> torch.Tensor:
    """:func:`ops.correlate` of ``(V, n)`` series against ``ref`` (one
    ``(n,)`` series, or ``(V, n)`` series voxel by voxel), in voxel
    chunks."""
    def ref_rows(s):
        return ref[s:s + voxel_chunk] if ref.dim() == 2 else ref

    return torch.cat([
        correlate(ref_rows(s), series[s:s + voxel_chunk], measure, **kwargs)
        for s in range(0, series.shape[0], voxel_chunk)
    ]) if series.shape[0] else torch.empty(0, device=series.device)


def nan_bounds(t: torch.Tensor, chunk: int = 1 << 26):
    """(nanmin, nanmax) of ``t`` as 0-d tensors, over chunks of the
    flattened tensor (no full-size temporary)."""
    flat = t.reshape(-1)
    lo, hi = [], []
    for s in range(0, flat.numel(), chunk):
        part = flat[s:s + chunk]
        nan = torch.isnan(part)
        lo.append(torch.where(nan, torch.inf, part).amin())
        hi.append(torch.where(nan, -torch.inf, part).amax())
    return torch.stack(lo).amin(), torch.stack(hi).amax()


def correlate_field(
    stack: torch.Tensor,
    ref: torch.Tensor,
    measure="pearson",
    *,
    num_bins: int = 80,
    k: int = 3,
    kraskov_estimator: int = 1,
    absolute: bool = False,
    mi_bounds=None,
    chunk_budget_bytes: int = DEFAULT_CHUNK_BUDGET_BYTES,
) -> torch.Tensor:
    """Correlate every voxel's member series against a reference.

    Args:
      stack: ``(Z, Y, X, n)`` member stack (member axis last), float32 or
        a narrower float (a bfloat16 stack is upcast once: exact).
      ref: an ``(n,)`` reference series (SINGLE and SEPARATE modes) or a
        ``(Z, Y, X, n)`` second stack correlated voxel by voxel
        (SEPARATE_SYMMETRIC mode), on the stack's device.
      measure: measure id or enum.
      num_bins, k, kraskov_estimator: the binned-MI bins, and KSG's
        neighbour count and estimator.
      absolute: return |value|.
      mi_bounds: global ``(min, max)`` normalization bounds for binned
        MI; by default the global ranges of the reference series and of
        the stack (NaN ignored), as the reference normalizes by the
        global field range (CorrelationCalculator.cpp:820-845).
      chunk_budget_bytes: working-set budget of the binned-MI path.

    Returns:
      ``(Z, Y, X)`` float32 correlation field.
    """
    m = measure_from_id(measure)
    # The kernels take float32; JAX upcasts a bfloat16 stack before its
    # kernels too. The upcast is exact and holds a float32 copy while the
    # field is computed.
    if stack.dtype != torch.float32:
        stack = stack.float()
    if ref.dtype != torch.float32:
        ref = ref.float()
    if is_measure_binned_mi(m) and mi_bounds is None:
        mi_bounds = (nan_bounds(ref), nan_bounds(stack))
    n = stack.shape[-1]
    if ref.dim() > 1:
        ref = ref.reshape(-1, n)
    out = _correlate_field_flat(
        stack.reshape(-1, n).contiguous(), ref, m, num_bins=num_bins, k=k,
        kraskov_estimator=kraskov_estimator, mi_bounds=mi_bounds,
        chunk_budget_bytes=chunk_budget_bytes)
    if absolute:
        out = out.abs()
    return out.reshape(stack.shape[:-1])


def _correlate_field_flat(series: torch.Tensor, ref: torch.Tensor,
                          m: CorrelationMeasure, *, num_bins: int, k: int,
                          kraskov_estimator: int, mi_bounds,
                          chunk_budget_bytes: int) -> torch.Tensor:
    """Flat-series core of :func:`correlate_field`: (V, n) → (V,)."""
    n = series.shape[-1]
    if ref.dim() == 2:
        chunk = min(_auto_chunk(n, chunk_budget_bytes, num_bins, m),
                    max(series.shape[0], 1))
        return _correlate_chunked(series, ref, m, chunk, num_bins=num_bins,
                                  k=k, kraskov_estimator=kraskov_estimator,
                                  mi_bounds=mi_bounds)
    if m == CorrelationMeasure.PEARSON:
        return pearson_cuda(series, ref)
    if m == CorrelationMeasure.SPEARMAN:
        return spearman_cuda(series, ref)
    if m == CorrelationMeasure.KENDALL:
        return kendall_cuda(series, ref)
    if is_measure_kraskov_mi(m):
        out = mi_ksg_banded(series, ref, k=k, estimator=kraskov_estimator)
        if m == CorrelationMeasure.KMI_CORRELATION_COEFFICIENT:
            out = kmi_correlation_coefficient(out)
        return out
    chunk = min(_auto_chunk(n, chunk_budget_bytes, num_bins),
                max(series.shape[0], 1))
    return _correlate_chunked(series, ref, m, chunk, num_bins=num_bins,
                              mi_bounds=mi_bounds)


def pearson_streamed(chunks, ref: torch.Tensor) -> torch.Tensor:
    """Pearson field of a member stack streamed in member chunks.

    The JAX repo's ``bench.py`` streaming loop (``accumulate_onepass``
    over the chunks, then ``assemble``), moved into the library so that
    ``chip_smoke.py`` and a later bench share one implementation: B1 adds
    each chunk's ``(Σy, Σy², Σxy)`` to float32 running sums, and the field
    is assembled once at the end. Nothing waits on the device in between,
    so the chunks' launches queue back to back. A stack too large for the
    card (250³ × 1000 float32 is 62.5 GB) streams through a few resident
    chunk buffers.

    Args:
      chunks: iterable of member-major ``(E_c, Z, Y, X)`` float32 or
        bfloat16 chunks, in member order, on one device.
      ref: ``(n,)`` float32 reference series, ``n = Σ E_c``.

    Returns:
      ``(Z, Y, X)`` float32 Pearson field.
    """
    with zone("field.streamed"):
        acc, spatial, seen = None, None, 0
        for chunk in chunks:
            e = chunk.shape[0]
            if acc is None:
                spatial = chunk.shape[1:]
                acc = torch.zeros((3, chunk[0].numel()), dtype=torch.float32,
                                  device=chunk.device)
            elif chunk.shape[1:] != spatial:
                raise ValueError(f"chunk {tuple(chunk.shape)} does not "
                                 f"match the grid {tuple(spatial)}")
            chunk_moments_flat(chunk.reshape(e, -1), ref[seen:seen + e],
                               acc=acc)
            seen += e
        if acc is None or seen != ref.shape[0]:
            raise ValueError(f"the chunks hold {seen} members, "
                             f"ref {ref.shape[0]}")
        return pearson_from_moments(acc[0], acc[1], acc[2],
                                    ref).reshape(spatial)


def correlate_requests(
    stack: torch.Tensor,
    requests_a,
    requests_b,
    measure="pearson",
    stack_b: torch.Tensor | None = None,
    **kwargs,
) -> torch.Tensor:
    """Request-buffer mode: correlate arbitrary voxel pairs.

    The reference feeds ``RequestData{xi,yi,zi,xj,yj,zj}`` buffers
    through a 1D compute dispatch (CorrelationMain.glsl,
    USE_REQUESTS_BUFFER); here the requests index the flattened grid, and
    the pairs are gathered on the stack's device and correlated there.

    Args:
      stack: ``(Z, Y, X, n)`` member stack.
      requests_a / requests_b: ``(R, 3)`` integer voxel coordinates
        (z, y, x) or ``(R,)`` flat indices, as arrays or tensors.
      measure: measure id or enum; ``kwargs`` go to ``ops.correlate``.
      stack_b: optional second stack for pair-field requests.

    Returns:
      ``(R,)`` correlation values on the stack's device.
    """
    m = measure_from_id(measure)
    stack_b = stack if stack_b is None else stack_b
    flat = stack.reshape(-1, stack.shape[-1])
    flat_b = stack_b.reshape(-1, stack_b.shape[-1])
    ia = _request_index(requests_a, stack.shape[:3], stack.device)
    ib = _request_index(requests_b, stack_b.shape[:3], stack_b.device)
    return correlate(flat[ia], flat_b[ib], m, **kwargs)


def _request_index(req, shape, device) -> torch.Tensor:
    """Flat voxel indices of ``(R, 3)`` (z, y, x) coordinates or of
    ``(R,)`` flat indices, as an int64 tensor on ``device``."""
    req = torch.as_tensor(req).to(device=device, dtype=torch.int64)
    if req.dim() == 2:
        return (req[:, 0] * shape[1] + req[:, 1]) * shape[2] + req[:, 2]
    return req


@register_calculator_type("correlation")
class CorrelationCalculator(Calculator):
    """Reference-point correlation field as a virtual scalar field
    (``correrender_tpu/calculators/correlation.py:389-616``).

    In ensemble mode the series are the members at the queried time; in
    time mode (``ensemble_mode=False``) they are the time steps of the
    queried member, so the field does not depend on the time it is asked
    for, yet it is cached per (time, member) like every field, as in the
    JAX package.
    """

    def __init__(
        self,
        field_name: str | None = None,
        field_name_ref: str | None = None,
        measure="pearson",
        reference_point=(0, 0, 0),  # (x, y, z) voxel indices
        ensemble_mode: bool = True,
        num_bins: int = 80,
        k: int = 3,
        kraskov_estimator: int = 1,
        absolute: bool = False,
        symmetric_fields: bool = False,
        use_time_lag_correlations: bool = False,
        time_lag_time_step_idx: int = 0,
        time_lag: int = 0,
        use_render_restriction: bool = False,
        render_restriction_radius: float = 0.05,
        render_restriction_metric: str = "Euclidean",
        output_name: str | None = None,
    ):
        super().__init__(output_name)
        self.field_name = field_name
        self.field_name_ref = field_name_ref or field_name
        self.measure = measure_from_id(measure)
        self.reference_point = tuple(int(c) for c in reference_point)
        self.ensemble_mode = ensemble_mode
        self.num_bins = num_bins
        self.k = k
        self.kraskov_estimator = kraskov_estimator
        self.absolute = absolute
        self.symmetric_fields = symmetric_fields
        # Ensemble mode, the reference's time-lag correlations
        # (CorrelationCalculator.cpp:805-811): the reference series is
        # taken at the absolute time step time_lag_time_step_idx.
        self.use_time_lag_correlations = use_time_lag_correlations
        self.time_lag_time_step_idx = int(time_lag_time_step_idx)
        # Time mode (the JAX package's extension): correlate x_t with
        # ref_{t+lag} over the truncated overlap, no circular wrap.
        self.time_lag = int(time_lag)
        # A ball around the reference point that restricts rendering
        # (CorrelationCalculator.hpp:134-137); read by Scene.render_view.
        self.use_render_restriction = use_render_restriction
        self.render_restriction_radius = render_restriction_radius
        self.render_restriction_metric = render_restriction_metric

    def default_output_name(self):
        return MEASURE_NAMES[self.measure] + " Correlation"

    def set_reference_point(self, x: int, y: int, z: int):
        self.reference_point = (x, y, z)
        if self.volume_data is not None:
            self.volume_data.mark_dirty(self.output_name)

    def _stack(self, name, time, member):
        vd = self.volume_data
        if self.ensemble_mode:
            return vd.get_member_stack(name, time)
        return vd.get_time_stack(name, member)

    def compute(self, time: int, member: int) -> torch.Tensor:
        vd = self.volume_data
        field = self.field_name or vd.field_names[0]
        field_ref = self.field_name_ref or field
        stack = self._stack(field, time, member)
        if self.symmetric_fields:
            ref = self._stack(field_ref, time, member)
        else:
            ref_time = time
            if self.ensemble_mode and self.use_time_lag_correlations:
                ref_time = self.time_lag_time_step_idx
            ref_stack = (
                stack if field_ref == field and ref_time == time
                else self._stack(field_ref, ref_time, member))
            x, y, z = self.reference_point
            ref = ref_stack[z, y, x]
            if self.time_lag != 0 and not self.ensemble_mode:
                lag = self.time_lag
                ts = stack.shape[-1]
                if abs(lag) >= ts:
                    raise ValueError(f"time_lag {lag} >= series length {ts}")
                if lag > 0:
                    stack = stack[..., :ts - lag]
                    ref = ref[lag:]
                else:
                    stack = stack[..., -lag:]
                    ref = ref[:ts + lag]
        mi_bounds = None
        if is_measure_binned_mi(self.measure):
            lo, hi = vd.get_global_min_max(field, self.ensemble_mode, time,
                                           member)
            # The reference series' bounds come from its own time step:
            # under time-lag correlation, the absolute lag step.
            ref_bounds_time = time
            if (not self.symmetric_fields and self.ensemble_mode
                    and self.use_time_lag_correlations):
                ref_bounds_time = self.time_lag_time_step_idx
            lo2, hi2 = vd.get_global_min_max(field_ref, self.ensemble_mode,
                                             ref_bounds_time, member)
            mi_bounds = ((lo2, hi2), (lo, hi))
        return correlate_field(
            stack, ref, self.measure, num_bins=self.num_bins, k=self.k,
            kraskov_estimator=self.kraskov_estimator, absolute=self.absolute,
            mi_bounds=mi_bounds)

    # -- state files (keys from CorrelationCalculator.cpp) ----------------

    @classmethod
    def settings_to_kwargs(cls, s: dict) -> dict:
        name_to_measure = {v: k for k, v in MEASURE_NAMES.items()}
        kwargs = {}
        if "correlation_measure_type" in s:
            v = s["correlation_measure_type"]
            kwargs["measure"] = name_to_measure.get(v) or measure_from_id(v)
        if "reference_point_x" in s:
            kwargs["reference_point"] = (
                int(s.get("reference_point_x", 0)),
                int(s.get("reference_point_y", 0)),
                int(s.get("reference_point_z", 0)),
            )
        if "correlation_mode" in s:
            kwargs["ensemble_mode"] = s["correlation_mode"] == "Ensemble"
        if "mi_bins" in s:
            kwargs["num_bins"] = int(s["mi_bins"])
        if "kmi_neighbors" in s:
            kwargs["k"] = int(s["kmi_neighbors"])
        if "kraskov_estimator_index" in s:
            kwargs["kraskov_estimator"] = int(s["kraskov_estimator_index"]) + 1
        if "calculate_absolute_value" in s:
            kwargs["absolute"] = bool(s["calculate_absolute_value"])
        if "scalar_field_name" in s:
            kwargs["field_name"] = s["scalar_field_name"]
        if "correlation_field_mode" in s:
            kwargs["symmetric_fields"] = (
                s["correlation_field_mode"] == "Separate Symmetric")
        if "scalar_field_name_ref" in s:
            kwargs["field_name_ref"] = s["scalar_field_name_ref"]
        if "time_lag" in s:
            kwargs["time_lag"] = int(s["time_lag"])
        if "use_time_lag_correlations" in s:
            kwargs["use_time_lag_correlations"] = bool(
                s["use_time_lag_correlations"])
        if "time_lag_time_step_idx" in s:
            kwargs["time_lag_time_step_idx"] = int(
                s["time_lag_time_step_idx"])
        if "restrict_rendering" in s:
            kwargs["use_render_restriction"] = bool(s["restrict_rendering"])
        if "render_restriction_radius" in s:
            kwargs["render_restriction_radius"] = float(
                s["render_restriction_radius"])
        if "distance_metric" in s:
            kwargs["render_restriction_metric"] = str(s["distance_metric"])
        return kwargs

    def get_settings(self) -> dict:
        restriction = (
            {"render_restriction_radius": self.render_restriction_radius,
             "distance_metric": self.render_restriction_metric}
            if self.use_render_restriction else {})
        return {
            "restrict_rendering": self.use_render_restriction,
            **restriction,
            "correlation_measure_type": MEASURE_NAMES[self.measure],
            "correlation_mode": "Ensemble" if self.ensemble_mode else "Time",
            "reference_point_x": self.reference_point[0],
            "reference_point_y": self.reference_point[1],
            "reference_point_z": self.reference_point[2],
            "mi_bins": self.num_bins,
            "kmi_neighbors": self.k,
            "kraskov_estimator_index": self.kraskov_estimator - 1,
            "calculate_absolute_value": self.absolute,
            "scalar_field_name": self.field_name,
            "correlation_field_mode": (
                "Separate Symmetric" if self.symmetric_fields
                else "Separate"
                if self.field_name_ref
                and self.field_name_ref != self.field_name
                else "Single"),
            **({"scalar_field_name_ref": self.field_name_ref}
               if self.field_name_ref else {}),
            **({"time_lag": self.time_lag} if self.time_lag else {}),
            "use_time_lag_correlations": self.use_time_lag_correlations,
            "time_lag_time_step_idx": self.time_lag_time_step_idx,
        }
