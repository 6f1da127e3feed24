"""LRU field cache with a device-memory budget.

Counterpart of ``correrender_tpu/core/cache.py`` (the reference's
src/Volume/Cache/FieldCache.hpp): an LRU keyed by (name, time, member)
with a byte budget, and a min/max side cache (FieldMinMaxCache). Entries
are tensors, counted by their bytes (``numel × element_size``). Dropping
a handle is always safe: the caching allocator frees a tensor's memory
once no reference remains, so the reference's eviction wait-list has no
counterpart. The JAX cache's auxiliary reservations have no caller in
either package and are not ported.
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
        self.used_bytes = 0

    def get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
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

        Like the reference with ``failOnCacheExhaustion=false``, a slab
        larger than the whole budget is still stored. The min/max side
        cache survives eviction (two floats a slab; only
        :meth:`invalidate_field`, a data change, clears it).
        """
        while self.used_bytes + size > self.max_bytes and self._entries:
            old_key, _ = self._entries.popitem(last=False)
            self.used_bytes -= self._sizes.pop(old_key)

    def invalidate_field(self, name: str):
        for k in [k for k in self._entries if k[0] == name]:
            del self._entries[k]
            self.used_bytes -= self._sizes.pop(k)
        for k in [k for k in self._min_max if k[0] == name]:
            del self._min_max[k]

    def get_min_max(self, key):
        return self._min_max.get(key)

    def put_min_max(self, key, mm):
        self._min_max[key] = mm

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries
