"""The central volume data model.

Counterpart of ``correrender_tpu/core/fields.py`` (the reference's
``VolumeData`` hub, src/Volume/VolumeData.{hpp,cpp}): a 5D scalar-field
ensemble addressed as ``field(name, time, member) -> (Z, Y, X)`` tensor,
with grid metadata, a registry of named fields fed by loaders and by
calculators (a calculator's output is a virtual field, computed on first
access), and an LRU cache with a device-memory budget.

A ``VolumeData`` lives on one device (the card unless the caller asks
for the CPU): a provider's slab is uploaded there once, as float32, and
cached; member and time stacks are built there from the cached slabs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import numpy as np
import torch

from correrender_tpu_torch.core.cache import LRUFieldCache
from correrender_tpu_torch.utils.profiling import zone


class FieldType(enum.Enum):
    """Mirrors the reference's FieldType (scalar / vector / color)."""

    SCALAR = "scalar"
    VECTOR = "vector"
    COLOR = "color"


@dataclasses.dataclass(frozen=True)
class GridMetadata:
    """Grid dimensions, spacing and derived boxes."""

    xs: int
    ys: int
    zs: int
    ts: int = 1
    es: int = 1
    dx: float = 1.0
    dy: float = 1.0
    dz: float = 1.0
    #: Render-only y stretch (catalog heightscale; physical spacing stays
    #: dx/dy/dz).
    render_height_scale: float = 1.0

    @property
    def shape_zyx(self):
        return (self.zs, self.ys, self.xs)

    @property
    def num_voxels(self):
        return self.xs * self.ys * self.zs

    def world_box(self):
        """Render-space AABB ``[(0,0,0), ((xs-1)dx, h(ys-1)dy, (zs-1)dz)]``
        (h = render_height_scale)."""
        return (
            np.zeros(3, np.float32),
            np.array(
                [
                    (self.xs - 1) * self.dx,
                    (self.ys - 1) * self.dy * self.render_height_scale,
                    (self.zs - 1) * self.dz,
                ],
                np.float32,
            ),
        )

    def render_box(self):
        """Normalized render AABB: ±0.25 · extent / max(extent), the
        extent counting the spacing (VolumeData.cpp:322-330)."""
        _, wmax = self.world_box()
        dims = np.maximum(wmax, 1e-30)
        normalized = dims / dims.max()
        return (-0.25 * normalized).astype(np.float32), (
            0.25 * normalized
        ).astype(np.float32)


class VolumeData:
    """Field registry and lazy cache over a fixed grid, on one device.

    Field providers are callables ``(time, member) -> (Z, Y, X)`` numpy
    array or tensor; loaders register file-backed providers, calculators
    compute-backed ones. Every access goes through :meth:`get_field`, so
    a caller cannot tell a loaded field from a derived one.
    """

    def __init__(self, grid: GridMetadata, cache_bytes: Optional[int] = None,
                 member_stack_dtype: torch.dtype | None = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"VolumeData on {self.device}: no CUDA device is present "
                "(pass device='cpu' for a CPU volume)")
        self.grid = grid
        self._providers: dict[str, tuple] = {}
        self._calculators: dict[str, object] = {}
        self.cache = LRUFieldCache(max_bytes=cache_bytes, device=self.device)
        self._dirty_epochs: dict[str, int] = {}
        # Storage dtype of resident member and time stacks; bfloat16
        # halves their residency (the reference's float16 format_cast).
        # The estimators compute in float32 regardless.
        self.member_stack_dtype = member_stack_dtype or torch.float32
        #: A dataset's 4×4 model matrix (catalog ``transform``), or None.
        self.model_matrix = None

    # -- registry ---------------------------------------------------------

    def add_field(self, name: str, provider: Callable,
                  field_type: FieldType = FieldType.SCALAR):
        if name in self._providers:
            # Re-registration replaces the provider: derived render state
            # keyed on the dirty epoch must not survive it.
            self.mark_dirty(name)
        self._providers[name] = (field_type, provider)

    def add_calculator(self, calculator):
        """Register a calculator; its output becomes a virtual field
        (``VolumeData::addCalculator``, VolumeData.cpp:1046)."""
        name = calculator.output_name
        self._calculators[name] = calculator
        calculator.bind(self)
        self.add_field(
            name,
            lambda t, e, _c=calculator: _c.compute(t, e),
            calculator.output_type,
        )

    def rename_field(self, old: str, new: str):
        """Move a registered (calculator) field to a new name, keeping the
        registry order; cached slabs and epoch-keyed state of both names
        are invalidated."""
        if old == new:
            return
        if old not in self._providers:
            raise KeyError(
                f"field {old!r} not found; available: {self.field_names}")
        if new in self._providers:
            raise ValueError(f"field {new!r} already registered")
        self._providers = {(new if k == old else k): v
                           for k, v in self._providers.items()}
        if old in self._calculators:
            self._calculators = {(new if k == old else k): v
                                 for k, v in self._calculators.items()}
        self.mark_dirty(old)
        self.mark_dirty(new)

    def remove_calculator(self, name: str):
        self._calculators.pop(name, None)
        self._providers.pop(name, None)
        self.mark_dirty(name)

    @property
    def field_names(self):
        return list(self._providers)

    @property
    def calculators(self):
        return dict(self._calculators)

    def field_exists(self, name: str) -> bool:
        return name in self._providers

    # -- access -----------------------------------------------------------

    def get_field(self, name: str, time: int = 0,
                  member: int = 0) -> torch.Tensor:
        """One ``(Z, Y, X)`` float32 slab on the volume's device, fetched
        from its provider on first access and cached."""
        key = (name, time, member)
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        if name not in self._providers:
            raise KeyError(
                f"field {name!r} not found; available: {self.field_names}")
        _, provider = self._providers[name]
        with zone("field.compute"):
            arr = provider(time, member)
        if isinstance(arr, np.ndarray):
            arr = np.ascontiguousarray(arr, np.float32)
            # A decoder may return a read-only view of the file's bytes,
            # which a tensor must not alias.
            arr = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        arr = arr.to(device=self.device, dtype=torch.float32).contiguous()
        # Vector and colour fields carry a trailing component axis.
        if tuple(arr.shape[:3]) != self.grid.shape_zyx:
            raise ValueError(
                f"provider for {name!r} returned {tuple(arr.shape)}, "
                f"expected leading dims {self.grid.shape_zyx}")
        self.cache.put(key, arr)
        return arr

    def _stack(self, name: str, key, slab_keys) -> torch.Tensor:
        hit = self.cache.get(key) if key is not None else None
        if hit is not None:
            return hit
        slabs = [self.get_field(name, t, e) for t, e in slab_keys]
        stack = torch.stack(slabs, dim=-1).to(self.member_stack_dtype)
        if key is not None:
            self.cache.put(key, stack)
        return stack

    def get_member_stack(self, name: str, time: int = 0,
                         members=None) -> torch.Tensor:
        """The ensemble axis last: ``(Z, Y, X, E)`` in
        ``member_stack_dtype``. The full stack is cached like a slab (it
        is the correlation's hot input)."""
        key = (name, time, "__stack__") if members is None else None
        members = range(self.grid.es) if members is None else members
        return self._stack(name, key, [(time, e) for e in members])

    def get_time_stack(self, name: str, member: int = 0,
                       times=None) -> torch.Tensor:
        """The time axis last: ``(Z, Y, X, T)`` (time-correlation mode),
        cached and typed like :meth:`get_member_stack`."""
        key = (name, member, "__tstack__") if times is None else None
        times = range(self.grid.ts) if times is None else times
        return self._stack(name, key, [(t, member) for t in times])

    def get_correlation_member_count(self, ensemble_mode: bool = True) -> int:
        """The ensemble size or the time-step count
        (CorrelationCalculator.hpp:89)."""
        return self.grid.es if ensemble_mode else self.grid.ts

    def get_min_max(self, name: str, time: int = 0, member: int = 0):
        """Cached per-slab (nanmin, nanmax) as Python floats (the
        reference's FieldMinMaxCache); an all-NaN slab gives NaN. One
        host sync a slab on the first call, none after."""
        key = (name, time, member)
        mm = self.cache.get_min_max(key)
        if mm is None:
            arr = self.get_field(name, time, member)
            nan = torch.isnan(arr)
            lo = torch.where(nan, torch.inf, arr).amin()
            hi = torch.where(nan, -torch.inf, arr).amax()
            lo, hi = torch.stack([lo, hi]).tolist()
            mm = (lo, hi) if lo <= hi else (float("nan"), float("nan"))
            self.cache.put_min_max(key, mm)
        return mm

    def get_global_min_max(self, name: str, ensemble_mode: bool = True,
                           time: int = 0, member: int = 0):
        """Min/max across all members (or, in time mode, all time steps of
        ``member``'s series): the binned-MI normalization
        (CorrelationCalculator.cpp:820-845)."""
        cs = self.get_correlation_member_count(ensemble_mode)
        lo, hi = np.inf, -np.inf
        for c in range(cs):
            t, e = (time, c) if ensemble_mode else (c, member)
            mn, mx = self.get_min_max(name, t, e)
            lo, hi = min(lo, mn), max(hi, mx)
        return lo, hi

    def mark_dirty(self, name: str, _visited: set | None = None):
        """Invalidate a field's cached slabs, bump its dirty epoch, and
        propagate to every calculator that reads it (per
        ``Calculator.input_fields``), transitively."""
        self.cache.invalidate_field(name)
        self._dirty_epochs[name] = self._dirty_epochs.get(name, 0) + 1
        visited = _visited if _visited is not None else {name}
        first = next(iter(self._providers), None)
        for out, calc in self._calculators.items():
            if out == name or out in visited:
                continue
            deps = calc.input_fields()
            # None deps: undeclared, so always dependent; a None entry
            # means "the first field".
            hit = deps is None or name in deps or (
                None in deps and name == first)
            if hit:
                visited.add(out)
                self.mark_dirty(out, visited)

    def dirty_epoch(self, name: str) -> int:
        """Monotonic per-field version counter, bumped by mark_dirty: the
        invalidation token of derived render state."""
        return self._dirty_epochs.get(name, 0)
