"""Input encodings for the neural correlation networks.

Counterpart of ``correrender_tpu/models/encodings.py`` (reference
src/Calculators/VMLP/Encoding.hpp:46-232, Data/Shaders/VMLP/
Encodings.glsl): Identity, Frequency, the instant-NGP grid (hash and
dense; prime, coherent_prime and reversed_prime hashes; linear and
nearest interpolation), Dictionary and Composite.

Each encoding is an ``nn.Module`` that holds its configuration and no
parameters: ``init(generator, device) -> params`` draws them (from a CPU
``torch.Generator``, then moved to ``device``), and
``forward(params, x) -> features`` computes, with ``params`` in the JAX
package's layout (``{"tables": [(size, F), ...]}`` for a grid), so a
preset or a JAX pytree maps on without reshaping. Positions ``x`` are
normalized to ``[0, 1]^D``.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

# Reference prime tables (Encodings.glsl:283-288): PRIME hashes every
# axis; COHERENT_PRIME leaves axis 0 unhashed (cache locality);
# REVERSED_PRIME walks the table backwards.
_PRIMES = (1958374283, 2654435761, 805459861, 3674653429,
           2097192037, 1434869437, 2165219737)

_UINT32 = 0xFFFFFFFF


# The constant tensors of a forward pass, made once a device: a tensor
# built from host values on the card copies from pageable memory, which
# waits for the stream, once a forward (and once a corner) otherwise.
@functools.lru_cache(maxsize=32)
def _frequencies(num_frequencies: int, device) -> torch.Tensor:
    """2^f·π, rounded to float32 as f32(π)·2^f: the JAX package's."""
    return torch.tensor([2.0 ** f * math.pi for f in range(num_frequencies)],
                        dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=32)
def _corner_offsets(dims: int, device) -> torch.Tensor:
    """(2^D, D) int64: corner ``mask``'s offset on axis d is bit d."""
    return torch.tensor([[(mask >> d) & 1 for d in range(dims)]
                         for mask in range(2**dims)], device=device)


class IdentityEncoding(nn.Module):
    def __init__(self, dims: int = 3):
        super().__init__()
        self.dims = dims

    @property
    def num_features(self):
        return self.dims

    def init(self, generator=None, device=None):
        return {}

    def forward(self, params, x):
        return x


class FrequencyEncoding(nn.Module):
    """NeRF-style sin/cos frequency features: for each axis the sines of
    ``2^f·π·x``, then their cosines, axis after axis."""

    def __init__(self, dims: int = 3, num_frequencies: int = 6):
        super().__init__()
        self.dims = dims
        self.num_frequencies = num_frequencies

    @property
    def num_features(self):
        return self.dims * self.num_frequencies * 2

    def init(self, generator=None, device=None):
        return {}

    def forward(self, params, x):
        ang = x[..., None] * _frequencies(self.num_frequencies,
                                          x.device)  # (..., D, F)
        feats = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return feats.reshape(x.shape[:-1] + (self.num_features,))


class HashGridEncoding(nn.Module):
    """Multiresolution hash/dense grid (instant-NGP-style)."""

    def __init__(self, dims: int = 3, num_levels: int = 8,
                 features_per_level: int = 2, log2_hashmap_size: int = 15,
                 base_resolution: int = 4, per_level_scale: float = 1.6,
                 grid_type: str = "hash", hash_type: str = "prime",
                 interpolation: str = "linear"):
        super().__init__()
        self.dims = dims
        self.num_levels = num_levels
        self.features_per_level = features_per_level
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.per_level_scale = per_level_scale
        self.grid_type = grid_type  # "hash" | "dense"
        # "prime" | "coherent_prime" | "reversed_prime"
        self.hash_type = hash_type
        self.interpolation = interpolation  # "linear" | "nearest"

    @property
    def num_features(self):
        return self.num_levels * self.features_per_level

    def _level_resolution(self, level: int) -> int:
        return int(
            math.floor(self.base_resolution * self.per_level_scale**level))

    def _table_size(self, level: int) -> int:
        dense = self._level_resolution(level) ** self.dims
        if self.grid_type == "dense":
            return dense
        return min(dense, 2**self.log2_hashmap_size)

    def init(self, generator=None, device=None):
        return {"tables": [
            torch.empty(self._table_size(lvl), self.features_per_level)
            .uniform_(-1e-4, 1e-4, generator=generator).to(device)
            for lvl in range(self.num_levels)]}

    def _index(self, corner: torch.Tensor, res: int, table_size: int):
        """corner: (..., D) integer grid coordinates → table index.

        The hash multiplies in uint32 with wrap-around: here in int64,
        each axis's product (a coordinate below 2^16 times a prime below
        2^32) masked to 32 bits, then XOR and ``%``, which gives the JAX
        package's indices exactly."""
        corner = corner.to(torch.int64)
        dense = res**self.dims
        if self.grid_type == "dense" or dense <= table_size:
            idx = corner[..., 0]
            for d in range(1, self.dims):
                idx = idx * res + corner[..., d]
            return idx
        primes = _PRIMES[: self.dims]
        if self.hash_type == "reversed_prime":
            primes = _PRIMES[::-1][: self.dims]
        elif self.hash_type == "coherent_prime":
            primes = (1,) + _PRIMES[1: self.dims]
        h = torch.zeros(corner.shape[:-1], dtype=torch.int64,
                        device=corner.device)
        for d in range(self.dims):
            h = h ^ ((corner[..., d] * primes[d]) & _UINT32)
        return h % table_size

    def forward(self, params, x):
        offsets = _corner_offsets(self.dims, x.device)
        outs = []
        for lvl, table in enumerate(params["tables"]):
            res = self._level_resolution(lvl)
            size = table.shape[0]
            p = x * (res - 1)
            if self.interpolation == "nearest":
                corner = torch.round(p).to(torch.int64).clamp(0, res - 1)
                outs.append(table[self._index(corner, res, size)])
                continue
            p0 = torch.floor(p)
            frac = p - p0
            p0 = p0.to(torch.int64)
            acc = 0.0
            # Corners and their weights in the mask's bit order, the
            # weight a product of frac or 1 - frac over the axes.
            for mask in range(2**self.dims):
                offs = [(mask >> d) & 1 for d in range(self.dims)]
                corner = (p0 + offsets[mask]).clamp(0, res - 1)
                w = None
                for d in range(self.dims):
                    wd = frac[..., d] if offs[d] else 1.0 - frac[..., d]
                    w = wd if w is None else w * wd
                idx = self._index(corner, res, size)
                acc = acc + w[..., None] * table[idx]
            outs.append(acc)
        return torch.cat(outs, dim=-1)


class DictionaryEncoding(nn.Module):
    """Learned per-index embedding (e.g. ensemble-member id)."""

    def __init__(self, num_embeddings: int = 1000, features: int = 8):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features

    @property
    def num_features(self):
        return self.features

    def init(self, generator=None, device=None):
        return {"table": (torch.randn(self.num_embeddings, self.features,
                                      generator=generator) * 0.1).to(device)}

    def forward(self, params, idx):
        return params["table"][idx.to(torch.int64)]


class CompositeEncoding(nn.Module):
    """Concatenation of encodings over slices of the input vector."""

    def __init__(self, encodings, slices):
        super().__init__()
        self.encodings = nn.ModuleList(encodings)
        self.slices = tuple(slices)  # (start, stop) per encoding

    @property
    def num_features(self):
        return sum(e.num_features for e in self.encodings)

    def init(self, generator=None, device=None):
        return {f"enc{i}": e.init(generator, device)
                for i, e in enumerate(self.encodings)}

    def forward(self, params, x):
        return torch.cat([
            enc(params[f"enc{i}"], x[..., a:b])
            for i, (enc, (a, b)) in enumerate(zip(self.encodings,
                                                   self.slices))], dim=-1)
