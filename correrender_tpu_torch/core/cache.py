"""LRU field cache with a device-memory budget.

Counterpart of ``correrender_tpu/core/cache.py`` (the reference's
src/Volume/Cache/FieldCache.hpp): an LRU keyed by (name, time, member)
with a byte budget, auxiliary-memory reservations that let a calculator
claim scratch budget, and a min/max side cache (FieldMinMaxCache).
Entries are tensors, counted by their bytes (``numel × element_size``).
Dropping a handle is always safe: the caching allocator frees a tensor's
memory once no reference remains, so the reference's eviction wait-list
has no counterpart.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Hashable, Optional

import torch

#: Budget of a CPU cache (the JAX package's fallback when the device
#: reports no memory limit).
CPU_BUDGET_BYTES = 4 << 30


def default_budget(device) -> int:
    """7/8 of the free memory of a CUDA ``device`` (the reference keeps
    7/8 of VRAM for its device cache, FieldCache.hpp:143), or
    :data:`CPU_BUDGET_BYTES` for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * 7 // 8)
    return CPU_BUDGET_BYTES


def tensor_bytes(t) -> int:
    return int(t.numel() * t.element_size())


class LRUFieldCache:
    """Byte-budgeted LRU over named tensor slabs."""

    def __init__(self, max_bytes: Optional[int] = None, device="cpu"):
        self.max_bytes = (max_bytes if max_bytes is not None
                          else default_budget(device))
        self._entries: OrderedDict[Hashable, torch.Tensor] = OrderedDict()
        self._sizes: dict[Hashable, int] = {}
        self._min_max: dict[Hashable, tuple] = {}
        self._aux_reserved = 0
        self.used_bytes = 0
        # Lookups that found no slab, and that found one (the perf
        # sweep's cache_misses column).
        self.hits = 0
        self.misses = 0

    def get(self, key):
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(key)
        return entry

    def put(self, key, tensor: torch.Tensor):
        size = tensor_bytes(tensor)
        self.ensure_free(size)
        if key in self._entries:
            self.used_bytes -= self._sizes[key]
        self._entries[key] = tensor
        self._sizes[key] = size
        self._entries.move_to_end(key)
        self.used_bytes += size

    def ensure_free(self, size: int):
        """Evict LRU entries until ``size`` bytes fit in the budget.

        The budget is ``max_bytes`` less the auxiliary reservations.
        Like the reference with ``failOnCacheExhaustion=false``, a slab
        larger than the whole budget is still stored. The min/max side
        cache survives eviction (two floats a slab; only
        :meth:`invalidate_field`, a data change, clears it).
        """
        budget = self.max_bytes - self._aux_reserved
        while self.used_bytes + size > budget and self._entries:
            old_key, _ = self._entries.popitem(last=False)
            self.used_bytes -= self._sizes.pop(old_key)

    def reserve_auxiliary(self, size: int) -> "AuxiliaryMemoryToken":
        """Evict until ``size`` bytes fit, then hold them back from the
        budget until the token is released (FieldCache.hpp:124-138)."""
        self.ensure_free(size)
        self._aux_reserved += size
        return AuxiliaryMemoryToken(self, size)

    def invalidate_field(self, name: str):
        for k in [k for k in self._entries if k[0] == name]:
            del self._entries[k]
            self.used_bytes -= self._sizes.pop(k)
        for k in [k for k in self._min_max if k[0] == name]:
            del self._min_max[k]

    def clear(self):
        """Drop every slab and min/max entry (reservations stay)."""
        self._entries.clear()
        self._sizes.clear()
        self._min_max.clear()
        self.used_bytes = 0

    def get_min_max(self, key):
        return self._min_max.get(key)

    def put_min_max(self, key, mm):
        self._min_max[key] = mm

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries


class AuxiliaryMemoryToken:
    """A reservation of :meth:`LRUFieldCache.reserve_auxiliary`, held
    until :meth:`release` (once; later calls do nothing) or the end of a
    ``with`` block."""

    def __init__(self, cache: LRUFieldCache, size: int):
        self._cache = cache
        self._size = size

    def release(self):
        if self._cache is not None:
            self._cache._aux_reserved -= self._size
            self._cache = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
